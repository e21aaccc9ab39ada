"""A frame of `render_image_blockwise` built by index gathers: the rays put
in 8×8 pixel-block order by `_tile_order`'s `order` (an index tensor made
from numpy), each chunk rendered by `_chunk`, the outputs concatenated and
put back in scanline order by its `inv`. The frame tests hold
`render_image_blockwise`, which permutes by views, bit for bit against it.
Imports no JAX, so the card's tests take it too."""

import torch

from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays
from fashion_nerf_torch.render import blockwise as bw


def gathered_frame(params, cfg, H, W, focal, c2w, occ=None, device="cpu"):
    """→ the dict `render_image_blockwise(params, cfg, H, W, focal, c2w,
    occ=occ, device=device)` returns, by gathers."""
    rays_o, rays_d = generate_rays(H, W, focal, c2w, device=device)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    viewdirs = rays_d
    if cfg.render.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    n = H * W
    tiled = H % 8 == 0 and W % 8 == 0
    if tiled:
        order, inv = (torch.from_numpy(a).to(device)
                      for a in bw._tile_order(H, W))
        rays_o, rays_d, viewdirs = (x[order]
                                    for x in (rays_o, rays_d, viewdirs))
    unit = bw.rays_per_chunk_unit(cfg)
    chunk = max(unit, (min(cfg.render.chunk, n) // unit) * unit)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        fill_d = torch.zeros((pad, 3), device=device)
        fill_d[:, 2] = -1.0
        rays_o = torch.cat([rays_o, torch.full((pad, 3), 1e6, device=device)])
        rays_d = torch.cat([rays_d, fill_d])
        viewdirs = torch.cat([viewdirs, fill_d])
    packed = bw.pack_render_params(params, cfg, occ)
    bg = 1.0 if cfg.render.white_bkgd else 0.0
    outs = [bw._chunk(params, cfg, rays_o, rays_d, viewdirs,
                      slice(c * chunk, (c + 1) * chunk), occ, packed, None,
                      bg, device)
            for c in range(n_chunks)]
    frame = {}
    for key in outs[0]:
        flat = torch.cat([o[key] for o in outs])[:n]
        if tiled:
            flat = flat[inv]
        frame[key] = flat.reshape((H, W) + flat.shape[1:])
    return frame
