"""Blockwise early-terminated rendering; counterpart of
`fashion_nerf.render.blockwise` for the flagship configuration.

Per chunk of rays: macro-box culling ranges (`ray_multi_aabb`), a σ-only
proposal march over one block of stratified samples (kernel K1), an
edge-bin PDF dilated and mixed with a uniform floor, deterministic fine
samples (`sample_pdf`), proposal-acc ray culling, and the fine march over
NB blocks with early termination and per-block macro-box culling (kernel
K2). Predication is per tile of TILE_ROWS // SB rays, as in the reference;
`render_image_blockwise` orders rays in 8×8 pixel blocks so a tile is a
pixel block, and skips chunks whose rays all miss the occupancy box.

`plain=True` routes every march through its plain PyTorch version on any
device: the reference frame that chip_smoke.py holds the kernels against.
Config branches off the flagship path raise NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fashion_nerf.config import Config
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.cameras import generate_rays
from fashion_nerf_torch.core.occupancy import (OccupancyState,
                                               ray_aabb_intersect,
                                               ray_multi_aabb)
from fashion_nerf_torch.core.sampling import sample_pdf, stratified_sample
from fashion_nerf_torch.kernels import sigmamarch, slimmarch
from fashion_nerf_torch.kernels.posenc_mlp import hoist_dirs

_INF_DIST = 1e10
_BRANCHES = "ROADMAP Queue 1 #15"


def _pass_dists(t_vals, dnorm, t_end, SB):
    """Per-sample integration widths (∞ or t_end on the last), scaled by
    ‖d‖, and t, both padded to a multiple of SB with zero-width sentinels."""
    R, S = t_vals.shape
    if t_end is None:
        upper_last = t_vals[:, -1:] + _INF_DIST
    else:
        upper_last = torch.clamp(t_vals[:, -1:], min=float(t_end))
    upper = torch.cat([t_vals[:, 1:], upper_last], dim=1)
    dists = (upper - t_vals) * dnorm
    pad = (-S) % SB
    return F.pad(t_vals, (0, pad)), F.pad(dists, (0, pad))


def _block_hit_flags(t_pad, SB, seg, R, NB):
    """(R, NB) f32: 1 where the block's t-range [first sample, max over the
    block] overlaps an occupied macro box; all ones without boxes."""
    if seg is None:
        return torch.ones((R, NB), dtype=torch.float32, device=t_pad.device)
    seg_lo, seg_hi, seg_hit = seg
    tb = t_pad.reshape(R, NB, SB)
    t_starts = tb[:, :, 0]
    t_ends = tb.amax(dim=2)
    overlap = ((seg_lo[:, None, :] <= t_ends[..., None])
               & (seg_hi[:, None, :] >= t_starts[..., None])
               & seg_hit[:, None, :])
    return overlap.any(dim=-1).float()


def _pdf_bins(t_c, weights, edge_bins: bool):
    """PDF bin edges + per-bin mass from the proposal pass: edge bins span
    [t_c[0], t_c[-1]] with all S weights; mid bins drop the end weights."""
    t_mid = 0.5 * (t_c[:, 1:] + t_c[:, :-1])
    if edge_bins:
        return torch.cat([t_c[:, :1], t_mid, t_c[:, -1:]], dim=1), weights
    return t_mid, weights[:, 1:-1]


def _disp(depth, acc):
    return 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)


def sigma_march_pass(net, hoists, t_vals, dnorm, alive0, cfg: Config, t_end,
                     seg=None, sb=None, plain: bool = False):
    """σ-only single-block proposal march → dict rgb (background), depth
    (0), acc, weights (R, S), disp."""
    R, S = t_vals.shape
    SB = sb or cfg.kernels.block_samples
    t_pad, d_pad = _pass_dists(t_vals, dnorm, t_end, SB)
    if t_pad.shape[1] != SB:
        raise ValueError(f"single-block march: {S} samples, SB={SB}")
    alive = alive0.float() * _block_hit_flags(t_pad, SB, seg, R, 1)[:, 0]
    fn = sigmamarch.sigma_march_plain if plain else sigmamarch.sigma_march
    w, acc, _ = fn(net, hoists, alive.contiguous(), t_pad.contiguous(),
                   d_pad.contiguous(),
                   cfg.model.sigma_activation == "softplus")
    rgb = torch.zeros((R, 3), dtype=torch.float32, device=w.device)
    if cfg.render.white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    depth = torch.zeros_like(acc)
    return {"rgb": rgb, "depth": depth, "acc": acc, "weights": w[:, :S],
            "disp": _disp(depth, acc)}


def marched_pass_slim(net, dirpart, hoists, t_vals, dnorm, alive0,
                      cfg: Config, t_end, seg=None, plain: bool = False):
    """Fine march over NB blocks of SB samples → dict rgb, depth, acc,
    weights (R, S), disp."""
    R, S = t_vals.shape
    SB = cfg.kernels.block_samples
    eps = cfg.kernels.early_term_eps
    t_pad, d_pad = _pass_dists(t_vals, dnorm, t_end, SB)
    NB = t_pad.shape[1] // SB
    log_eps = math.log(eps) if eps > 0 else -1e30
    block_hit = _block_hit_flags(t_pad, SB, seg, R, NB)
    fn = slimmarch.slim_march_plain if plain else slimmarch.slim_march
    rgb, w, _ = fn(net, hoists, dirpart, alive0.float().contiguous(),
                   block_hit.contiguous(), t_pad.contiguous(),
                   d_pad.contiguous(), log_eps,
                   cfg.model.sigma_activation == "softplus")
    acc = w.sum(dim=1)
    depth = (w * t_pad).sum(dim=1)
    if cfg.render.white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "depth": depth, "acc": acc, "weights": w[:, :S],
            "disp": _disp(depth, acc)}


def _check_supported(cfg: Config, params: dict):
    """Raise NotImplementedError on config branches off the flagship path."""
    p, k = cfg.proposal, cfg.kernels
    off = []
    if not (p.enabled and cfg.sampling.n_fine > 0 and "proposal" in params):
        off.append("no proposal net (full coarse march)")
    if not p.sigma_march:
        off.append("proposal.sigma_march=false")
    if not k.fused_carry or not k.carry_hoist:
        off.append("kernels.fused_carry/carry_hoist=false")
    if cfg.occupancy.sample_warp:
        off.append("occupancy.sample_warp")
    if cfg.model.conditioned or cfg.model.n_latents > 0:
        off.append("conditioned field")
    if cfg.render.ndc:
        off.append("render.ndc")
    if p.union or p.cov_n > 0:
        off.append("proposal.union / cov_n")
    if off:
        raise NotImplementedError(
            f"blockwise branches not ported: {', '.join(off)} ({_BRANCHES})")


def _budgets(cfg: Config, occ):
    """→ (n_prop, proposal SB, n_fine). The render-time eval budget applies
    only under occupancy culling, as in the reference."""
    scfg, rcfg = cfg.sampling, cfg.render
    n_fine = scfg.n_fine
    if occ is not None and (rcfg.eval_n_coarse > 0 or rcfg.eval_n_fine > 0):
        n_fine = rcfg.eval_n_fine or n_fine
    p_sb = cfg.proposal.block_samples or cfg.kernels.block_samples
    n_prop = cfg.proposal.eval_n or scfg.n_coarse
    if n_prop > p_sb:
        raise NotImplementedError(
            f"proposal eval_n {n_prop} > its block {p_sb}: the multi-block "
            f"proposal march is not ported ({_BRANCHES})")
    return n_prop, p_sb, n_fine


def rays_per_chunk_unit(cfg: Config) -> int:
    """Chunks must divide both march tiles (fine and proposal)."""
    p_sb = cfg.proposal.block_samples or cfg.kernels.block_samples
    return max(K.TILE_ROWS // cfg.kernels.block_samples,
               K.TILE_ROWS // p_sb)


def pack_render_params(params: dict) -> dict:
    """Pack the fine and proposal nets once per image."""
    return {"fine": slimmarch.split_hoist(params["fine"]),
            "proposal": sigmamarch.pack_sigma(params["proposal"])}


def culling(cfg: Config, rays_o, rays_d, occ: OccupancyState = None):
    """Occupancy culling of a chunk → (near, far, alive0 (R,) bool, seg,
    t_end): per-ray union intervals of the macro boxes (or the global box),
    their per-box segments, and the finite integration bound."""
    rcfg = cfg.render
    if occ is None:
        alive0 = torch.ones((rays_o.shape[0],), dtype=torch.bool,
                            device=rays_o.device)
        return rcfg.near, rcfg.far, alive0, None, None
    if cfg.occupancy.macro > 1:
        near, far, hit, s_lo, s_hi, s_hit = ray_multi_aabb(
            rays_o, rays_d, occ, rcfg.near, rcfg.far)
        return near, far, hit, (s_lo, s_hi, s_hit), rcfg.far
    near, far, hit = ray_aabb_intersect(rays_o, rays_d, occ.box_min,
                                        occ.box_max, rcfg.near, rcfg.far)
    return near, far, hit, None, rcfg.far


def fine_samples(cfg: Config, t_c, weights, n_fine: int):
    """Fine sample positions (sorted) from the proposal weights: edge-bin
    PDF, ±dilate max-pool, uniform floor, deterministic inverse CDF."""
    pdf_bins, w_mid = _pdf_bins(t_c, weights, cfg.proposal.edge_bins)
    k = cfg.proposal.dilate
    if k > 0:
        w_pad = torch.cat([w_mid[:, :1].expand(-1, k), w_mid,
                           w_mid[:, -1:].expand(-1, k)], dim=1)
        w_mid = w_pad.unfold(1, 2 * k + 1, 1).amax(dim=-1)
    a = cfg.proposal.uniform_mix
    if a > 0.0:
        w_mid = (1.0 - a) * w_mid + a * w_mid.mean(dim=-1, keepdim=True)
    return torch.sort(sample_pdf(pdf_bins, w_mid, n_fine), dim=-1).values


def render_rays_blockwise(params: dict, cfg: Config, rays_o, rays_d,
                          viewdirs, occ: OccupancyState = None,
                          packed: dict = None, plain: bool = False):
    """Proposal + fine render of (R,) rays, eval mode → {"coarse": dict,
    "fine": dict}. R must be a multiple of `rays_per_chunk_unit(cfg)`.
    params: {"fine": NeRFMLP, "proposal": NeRFMLP}; packed: its
    `pack_render_params` (packed here when None)."""
    _check_supported(cfg, params)
    n_prop, p_sb, n_fine = _budgets(cfg, occ)
    R = rays_o.shape[0]
    unit = rays_per_chunk_unit(cfg)
    if R % unit:
        raise ValueError(f"R={R} is not a multiple of {unit}")
    packed = packed or pack_render_params(params)
    near, far, alive0, seg, t_end = culling(cfg, rays_o, rays_d, occ)
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    prop = packed["proposal"]
    t_c = stratified_sample(near, far, R, n_prop, cfg.sampling.lindisp,
                            device=rays_o.device)
    out_c = sigma_march_pass(prop, sigmamarch.hoist_rays(prop, rays_o,
                                                         rays_d),
                             t_c, dnorm, alive0, cfg, t_end, seg=seg,
                             sb=p_sb, plain=plain)
    t_all = fine_samples(cfg, t_c, out_c["weights"], n_fine)

    fine = packed["fine"]
    alive_f = alive0
    if cfg.proposal.cull_acc > 0.0:
        alive_f = alive_f & (out_c["acc"] > cfg.proposal.cull_acc)
    out_f = marched_pass_slim(fine, hoist_dirs(fine, viewdirs),
                              slimmarch.hoist_rays(fine, rays_o, rays_d),
                              t_all, dnorm, alive_f, cfg, t_end, seg=seg,
                              plain=plain)
    return {"coarse": out_c, "fine": out_f}


def _tile_order(H: int, W: int, th: int = 8, tw: int = 8):
    """Ray permutation making each run of th·tw rays a th×tw pixel block,
    and its inverse (numpy int arrays)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    key = ((yy // th) * ((W + tw - 1) // tw) + (xx // tw)) * (th * tw) \
        + (yy % th) * tw + (xx % tw)
    order = np.argsort(key.reshape(-1), kind="stable")
    inv = np.argsort(order, kind="stable")
    return order, inv


def render_image_blockwise(params: dict, cfg: Config, H: int, W: int,
                           focal: float, c2w, occ: OccupancyState = None,
                           plain: bool = False, device=None):
    """Whole-image blockwise render → dict of (H, W[, 3]) rgb, depth, acc,
    disp, plus chunk_live (H, W) bool: whether the pixel's chunk was
    marched (False: the whole chunk missed the box and is background)."""
    if cfg.render.ndc:
        raise NotImplementedError(f"render.ndc ({_BRANCHES})")
    if device is None:
        device = next(params["fine"].parameters()).device
    rays_o, rays_d = generate_rays(H, W, focal, c2w, device=device)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n = rays_o.shape[0]
    tiled = H % 8 == 0 and W % 8 == 0
    inv = None
    if tiled:
        order, inv = _tile_order(H, W)
        order_t = torch.from_numpy(order).to(device)
        rays_o, rays_d = rays_o[order_t], rays_d[order_t]
    viewdirs = rays_d

    unit = rays_per_chunk_unit(cfg)
    chunk = max(unit, (min(cfg.render.chunk, n) // unit) * unit)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        # pad origins far outside any scene box so padding joins the
        # dead-chunk / dead-tile skip; unit directions keep norms finite
        fill_d = torch.zeros((pad, 3), device=device)
        fill_d[:, 2] = -1.0
        rays_o = torch.cat([rays_o, torch.full((pad, 3), 1e6,
                                               device=device)])
        rays_d = torch.cat([rays_d, fill_d])
        viewdirs = torch.cat([viewdirs, fill_d])

    packed = pack_render_params(params)
    bg = 1.0 if cfg.render.white_bkgd else 0.0
    outs = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        o, d, v = rays_o[sl], rays_d[sl], viewdirs[sl]
        live = True
        if occ is not None:
            _, _, hit = ray_aabb_intersect(o, d, occ.box_min, occ.box_max,
                                           cfg.render.near, cfg.render.far)
            live = bool(hit.any())
        if live:
            f = render_rays_blockwise(params, cfg, o, d, v, occ=occ,
                                      packed=packed, plain=plain)["fine"]
            out = {k: f[k] for k in ("rgb", "depth", "acc", "disp")}
        else:
            # the exact output every miss ray converges to
            out = {"rgb": torch.full((chunk, 3), bg, device=device),
                   "depth": torch.zeros((chunk,), device=device),
                   "acc": torch.zeros((chunk,), device=device),
                   "disp": torch.full((chunk,), 1e10, device=device)}
        out["chunk_live"] = torch.full((chunk,), live, dtype=torch.bool,
                                       device=device)
        outs.append(out)

    inv_t = torch.from_numpy(inv).to(device) if tiled else None

    def unchunk(key):
        flat = torch.cat([o[key] for o in outs])[:n]
        if tiled:
            flat = flat[inv_t]
        return flat.reshape((H, W) + flat.shape[1:])

    return {k: unchunk(k) for k in outs[0]}

