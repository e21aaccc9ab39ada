"""Dense renderer: stratified → coarse field → volume render → importance
resample → fine field → volume render. Counterpart of
`fashion_nerf.render.renderer` (`render_rays`, `render_image`,
`render_path`).

Training renders ray batches with jitter and σ noise drawn from an explicit
generator; evaluation is deterministic and renders whole images in chunks
of `cfg.render.chunk` rays. Without occupancy culling the evaluation
composites through kernel K5 (kernels/render.py) when the config asks for
the fused render; the culled path composites with `volume_render` and its
finite last interval, as the reference does. Under a device mesh
`render_image` deals whole chunks to the dp ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fashion_nerf_torch.config import Config
from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays
from fashion_nerf_torch.core.occupancy import (cull_background,
                                               ray_aabb_intersect)
from fashion_nerf_torch.core.sampling import sample_pdf, stratified_sample
from fashion_nerf_torch.core.volrend import volume_render
from fashion_nerf_torch.dist.mesh import axis_rank, axis_size
from fashion_nerf_torch.kernels.render import fused_render_rays


def render_rays(field_coarse: Callable, field_fine: Optional[Callable],
                rays_o, rays_d, cfg: Config, train: bool, generator=None,
                use_fused_render: bool = False, occ=None, cond=None):
    """Render a batch of rays → {"coarse": {...}, "fine": {...} or None},
    each a volume-render dict.

    field_*: bound fields (pts (R,S,3), rays_d) → (rgb, σ), called as
    field(pts, rays_d, cond) with a per-ray cond (R, Cc); field_fine None
    renders coarse only. train: stratified jitter and random PDF
    quantiles (sampling.perturb) and σ noise, drawn from `generator`;
    eval is deterministic. occ: an OccupancyState whose global box bounds
    each ray's interval; misses composite to background."""
    R = rays_o.shape[0]
    scfg, rcfg = cfg.sampling, cfg.render
    perturb = train and scfg.perturb
    noise = scfg.raw_noise_std if train else 0.0
    act = cfg.model.sigma_activation
    near, far, hit = rcfg.near, rcfg.far, None
    t_end = None
    if occ is not None:
        near, far, hit = ray_aabb_intersect(rays_o, rays_d, occ.box_min,
                                             occ.box_max, rcfg.near,
                                             rcfg.far)
        # σ beyond the box is at most the grid threshold: absorb over the
        # true leftover, not ∞
        t_end = rcfg.far

    def vr(rgb, sigma, t):
        if use_fused_render and occ is None:
            return fused_render_rays(rgb, sigma, t, rays_d, rcfg.white_bkgd,
                                     noise, generator, act)
        out = volume_render(rgb, sigma, t, rays_d, rcfg.white_bkgd, act,
                            t_end=t_end, raw_noise_std=noise,
                            generator=generator)
        return out if hit is None else cull_background(out, hit,
                                                       rcfg.white_bkgd)

    extra = () if cond is None else (cond,)
    t_c = stratified_sample(near, far, R, scfg.n_coarse, scfg.lindisp,
                            device=rays_o.device, perturb=perturb,
                            generator=generator)
    pts_c = rays_o[:, None, :] + rays_d[:, None, :] * t_c[..., None]
    rgb_c, sigma_c = field_coarse(pts_c, rays_d, *extra)
    out_c = vr(rgb_c, sigma_c, t_c)
    if scfg.n_fine <= 0 or field_fine is None:
        return {"coarse": out_c, "fine": None}

    t_mid = 0.5 * (t_c[:, 1:] + t_c[:, :-1])
    w_mid = out_c["weights"][:, 1:-1].detach()
    t_f = sample_pdf(t_mid, w_mid, scfg.n_fine, det=not perturb,
                     generator=generator)
    t_all = torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * t_all[..., None]
    rgb_f, sigma_f = field_fine(pts_f, rays_d, *extra)
    return {"coarse": out_c, "fine": vr(rgb_f, sigma_f, t_all)}


def _rays_for_pose(H: int, W: int, focal, c2w, cfg: Config, device=None):
    """(rays_o, rays_d, viewdirs), each (H·W, 3); NDC configs map the rays
    and keep the world directions for view dependence."""
    rays_o, rays_d = generate_rays(H, W, focal, c2w, device=device)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    viewdirs = rays_d
    if cfg.render.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def render_image(field_coarse: Callable, field_fine: Optional[Callable],
                 H: int, W: int, focal, c2w, cfg: Config,
                 use_fused_render: bool = False, occ=None, device=None,
                 cond=None, mesh=None):
    """Render an H×W image in chunks of cfg.render.chunk rays (the last one
    padded; pad directions are unit vectors) → dict rgb (H,W,3), depth,
    acc, disp (H,W). field_*: fields (pts (R,S,3), viewdirs (R,3)) →
    (rgb, σ); with a per-scene cond vector (Cc,) they are called as
    field(pts, viewdirs, cond (R, Cc)), the vector broadcast per chunk.

    mesh: a ("dp", ...) DeviceMesh; the chunk count is padded to a
    multiple of dp, each dp rank renders its run of whole chunks and an
    all_gather over "dp" assembles the image on every rank."""
    rays_o, rays_d, viewdirs = _rays_for_pose(H, W, focal, c2w, cfg, device)
    n = rays_o.shape[0]
    chunk = min(cfg.render.chunk, n)
    n_chunks = -(-n // chunk)
    ndp = 1 if mesh is None else axis_size(mesh, "dp")
    n_chunks = -(-n_chunks // ndp) * ndp        # chunk runs divide over dp
    per = n_chunks // ndp
    mine = range(axis_rank(mesh, "dp") * per,
                 (axis_rank(mesh, "dp") + 1) * per)
    pad = n_chunks * chunk - n
    unit = torch.zeros((pad, 3), device=rays_o.device)
    unit[:, 2] = -1.0
    ro = F.pad(rays_o, (0, 0, 0, pad))
    rd = torch.cat([rays_d, unit])
    vd = torch.cat([viewdirs, unit])
    cond_rays = None if cond is None else cond.expand(chunk, cond.shape[-1])
    outs = []
    for c in mine:
        sl = slice(c * chunk, (c + 1) * chunk)
        v = vd[sl]
        fc = (lambda pts, _rd, *c, v=v: field_coarse(pts, v, *c))
        ff = (None if field_fine is None
              else (lambda pts, _rd, *c, v=v: field_fine(pts, v, *c)))
        out = render_rays(fc, ff, ro[sl], rd[sl], cfg, train=False,
                          use_fused_render=use_fused_render, occ=occ,
                          cond=cond_rays)
        head = out["fine"] if out["fine"] is not None else out["coarse"]
        outs.append({k: head[k] for k in ("rgb", "depth", "acc", "disp")})
    rows = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    if ndp > 1:
        rows = _gather_rows(rows, mesh.get_group("dp"), ndp)
    return {k: v[:n].reshape((H, W) + v.shape[1:]) for k, v in rows.items()}


def _gather_rows(rows: dict, group, n_ranks: int) -> dict:
    """Every dp rank's rows of the image, in rank order: one all_gather of
    the (rows, 6) packing of rgb, depth, acc and disp."""
    packed = torch.cat([rows["rgb"], rows["depth"][:, None],
                        rows["acc"][:, None], rows["disp"][:, None]], 1)
    parts = [torch.empty_like(packed) for _ in range(n_ranks)]
    dist.all_gather(parts, packed.contiguous(), group=group)
    full = torch.cat(parts)
    return {"rgb": full[:, :3], "depth": full[:, 3], "acc": full[:, 4],
            "disp": full[:, 5]}


def render_path(field_coarse: Callable, field_fine: Optional[Callable],
                poses, H: int, W: int, focal, cfg: Config,
                use_fused_render: bool = False, occ=None, device=None,
                cond=None):
    """Render a camera path (test poses, a spiral, a rotation) with
    `render_image`, one pose after the other → rgb frames (N, H, W, 3)."""
    return torch.stack([
        render_image(field_coarse, field_fine, H, W, focal, c2w, cfg,
                     use_fused_render=use_fused_render, occ=occ,
                     device=device, cond=cond)["rgb"] for c2w in poses])
