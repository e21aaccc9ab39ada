"""Blockwise early-terminated rendering; counterpart of
`fashion_nerf.render.blockwise`.

Per chunk of rays: macro-box culling ranges (`ray_multi_aabb`), a σ-only
proposal march over one block of stratified samples (kernel K1), an
edge-bin PDF dilated and mixed with a uniform floor, deterministic fine
samples (`sample_pdf`), joined with stratified coverage samples under
`proposal.cov_n` or with the proposal samples under `proposal.union`,
proposal-acc ray culling, and the fine march over NB blocks with early
termination and per-block macro-box culling. Under
`occupancy.sample_warp` (with macro boxes, not `sampling.lindisp`) every
stratified set is placed on the occupied bins of each ray's union range
(`core.sampling.warp_stratified`), and every march caps each sample's
integration width at the end of the occupied run that holds it
(`delta_caps`). The
marches take one of three pipelines, as the reference's do:
- `kernels.fused_carry=true` (the flagship's): the carry march K2, or the
  generic carry march K6 under `kernels.carry_hoist=false`;
- `kernels.fused_carry=false` (the default, `llff_fern`'s): the two-stage
  march `marched_pass`, one launch of the field kernel K3 a sample block
  with a per-tile skip flag built from the carried log-transmittance, and
  the compositing in plain torch between the launches.
Without a proposal net the coarse pass is the full coarse march of the
coarse net through the same pipeline, and the fine samples come from its
mid-bin PDF joined with the coarse samples. The σ-only proposal march
takes K1 when `proposal.sigma_march` is set, the pipeline is the carry
march and its samples fit one block; otherwise it is the generic proposal
march: the proposal net, which has no view branch, through the same
pipeline as the fine march (K2 or K6, or K3 in the two-stage march).
Predication is per tile of TILE_ROWS // SB rays, as in the reference
(half that for the marches of a conditioned field); `render_image_blockwise`
maps the rays to NDC under `render.ndc` (the view directions stay the
world ones), orders rays in 8×8 pixel blocks so a tile is a pixel block
(scanline order when H or W is not a multiple of 8), and skips chunks
whose rays all miss the occupancy box. A conditioned field takes a per-scene cond
vector (garment code ⊕ latent); its per-ray condpart is hoisted once per
march (`posenc_mlp.hoist_cond`) and enters K2 folded into its
x-intercepts, K6 through its cond window. The proposal stays
unconditioned.

`plain=True` routes every march through its plain PyTorch version on any
device: the reference frame that chip_smoke.py holds the kernels against.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fashion_nerf_torch.config import Config
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays
from fashion_nerf_torch.core.occupancy import (OccupancyState,
                                               ray_aabb_intersect,
                                               ray_multi_aabb)
from fashion_nerf_torch.core.sampling import (delta_caps, occupancy_bins,
                                              sample_pdf, stratified_sample,
                                              warp_stratified)
from fashion_nerf_torch.kernels import carrymarch, sigmamarch, slimmarch
from fashion_nerf_torch.kernels.posenc_mlp import (field_rows,
                                                   field_rows_plain,
                                                   hoist_cond, hoist_dirs,
                                                   pack_params)
from fashion_nerf_torch.trace import span

_INF_DIST = 1e10


def _pass_dists(t_vals, dnorm, t_end, SB, cap=None):
    """Per-sample integration widths (∞ or t_end on the last), scaled by
    ‖d‖, and t, both padded to a multiple of SB with zero-width sentinels.
    cap: None, or (R, S) the end of the occupied run that holds each sample
    (`delta_caps`): a width then ends at max(cap, t) at the latest, so that
    no interval spans a culled gap between occupied runs."""
    R, S = t_vals.shape
    if t_end is None:
        upper_last = t_vals[:, -1:] + _INF_DIST
    else:
        upper_last = torch.clamp(t_vals[:, -1:], min=float(t_end))
    upper = torch.cat([t_vals[:, 1:], upper_last], dim=1)
    if cap is not None:
        upper = torch.minimum(upper, torch.maximum(cap, t_vals))
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
                     seg=None, sb=None, plain: bool = False, cap=None):
    """σ-only single-block proposal march → dict rgb (background), depth
    (0), acc, weights (R, S), disp. cap: the widths' caps (`_pass_dists`)."""
    R, S = t_vals.shape
    SB = sb or cfg.kernels.block_samples
    t_pad, d_pad = _pass_dists(t_vals, dnorm, t_end, SB, cap)
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


def _march_inputs(cfg: Config, t_vals, dnorm, t_end, seg, sb=None,
                  cap=None):
    """→ (t_pad, d_pad, block_hit, log ε) of a multi-block march of sb
    samples a block (default kernels.block_samples); cap: the widths' caps
    (`_pass_dists`)."""
    R = t_vals.shape[0]
    SB = sb or cfg.kernels.block_samples
    eps = cfg.kernels.early_term_eps
    t_pad, d_pad = _pass_dists(t_vals, dnorm, t_end, SB, cap)
    NB = t_pad.shape[1] // SB
    block_hit = _block_hit_flags(t_pad, SB, seg, R, NB)
    log_eps = math.log(eps) if eps > 0 else -1e30
    return (t_pad.contiguous(), d_pad.contiguous(), block_hit.contiguous(),
            log_eps)


def march_liveness(w, hit, block_hit, cfg: Config,
                   tile_rows: int = K.TILE_ROWS) -> dict:
    """The executed-(tile, block) diagnostic, reconstructed from the
    weights as the reference reconstructs it: T at a block's start is
    1 − Σ earlier weights, and the pair ran iff some ray of the tile
    (tile_rows // SB rays; the march's net.tile_rows) had hit ∧ block_hit
    ∧ T > ε. → tile_alive (n_tiles, NB) bool, alive_frac (its mean),
    ideal_frac (the per-ray mean)."""
    R, S_pad = w.shape
    NB = block_hit.shape[1]
    SB = S_pad // NB
    eps = cfg.kernels.early_term_eps
    cum_w = torch.cumsum(w, dim=1)
    t_start = 1.0 - torch.cat([torch.zeros_like(cum_w[:, :1]),
                               cum_w[:, :-1]], dim=1)
    ray_alive = ((hit > 0)[:, None] & (block_hit > 0)
                 & (t_start[:, ::SB] > (eps if eps > 0 else 0.0)))
    tile_alive = ray_alive.view(R // (tile_rows // SB), -1, NB).any(dim=1)
    return {"tile_alive": tile_alive,
            "alive_frac": tile_alive.float().mean(),
            "ideal_frac": ray_alive.float().mean()}


def _march_out(cfg: Config, rgb, depth, acc, w, S):
    if cfg.render.white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "depth": depth, "acc": acc, "weights": w[:, :S],
            "disp": _disp(depth, acc)}


def marched_pass_slim(net, dirpart, hoists, t_vals, dnorm, alive0,
                      cfg: Config, t_end, seg=None, plain: bool = False,
                      sb=None, cap=None):
    """March over NB blocks of SB samples through K2 → dict rgb, depth,
    acc, weights (R, S), disp. A net without a view branch (the proposal
    net) takes no dirpart. cap: the widths' caps (`_pass_dists`)."""
    t_pad, d_pad, block_hit, log_eps = _march_inputs(cfg, t_vals, dnorm,
                                                     t_end, seg, sb, cap)
    hit = alive0.float().contiguous()
    fn = slimmarch.slim_march_plain if plain else slimmarch.slim_march
    rgb, w, _ = fn(net, hoists, dirpart if net.has_vd else None, hit,
                   block_hit, t_pad, d_pad, log_eps,
                   cfg.model.sigma_activation == "softplus")
    return _march_out(cfg, rgb, (w * t_pad).sum(dim=1), w.sum(dim=1), w,
                      t_vals.shape[1])


def marched_pass_carry(net, dirpart, rays_o, rays_d, t_vals, dnorm, alive0,
                       cfg: Config, t_end, seg=None, plain: bool = False,
                       condpart=None, sb=None, cap=None):
    """The same march through the generic carry kernel K6 (the reference's
    `_marched_pass_carry`, `kernels.carry_hoist=false`): positions built
    per sample, depth and acc composited per block, a conditioned net's
    condpart through K6's cond window → the same dict."""
    t_pad, d_pad, block_hit, log_eps = _march_inputs(cfg, t_vals, dnorm,
                                                     t_end, seg, sb, cap)
    hit = alive0.float().contiguous()
    fn = carrymarch.carry_march_plain if plain else carrymarch.carry_march
    rgb, depth, acc, w, _ = fn(net, dirpart, rays_o.contiguous(),
                               rays_d.contiguous(), hit, block_hit, t_pad,
                               d_pad, log_eps,
                               cfg.model.sigma_activation == "softplus",
                               condpart=condpart)
    return _march_out(cfg, rgb, depth, acc, w, t_vals.shape[1])


def marched_pass(net, dirpart, condpart, rays_o, rays_d, t_vals, dnorm,
                 alive0, cfg: Config, t_end, seg=None, plain: bool = False,
                 sb=None, cap=None):
    """The two-stage march (the reference's `_marched_pass`,
    `kernels.fused_carry=false`): per block of SB samples, the rays still
    worth marching (alive0 ∧ logT > log ε ∧ the block overlaps an occupied
    macro box), one flag per predication tile (net.tile_rows // SB rays)
    as the max over its rays, the field on the block's positions
    o + d·t through K3 with those flags (a dead tile does no matrix work
    and gives σ = DEAD_SIGMA, so zero weight), then the compositing in
    plain torch: log(1 − α) floored at log(1e-10), the exclusive prefix,
    the weights and the rgb, depth and acc sums, and the carry. The flags
    stay on the device. → the march dict, with alive_frac: the share of
    (tile, block) launches that ran, read from the flags."""
    R, S = t_vals.shape
    SB = sb or cfg.kernels.block_samples
    t_pad, d_pad, block_hit, log_eps = _march_inputs(cfg, t_vals, dnorm,
                                                     t_end, seg, SB, cap)
    NB = t_pad.shape[1] // SB
    rpt = net.tile_rows // SB
    if R % rpt:
        raise ValueError(f"R={R} is not a multiple of {rpt}")
    softplus = cfg.model.sigma_activation == "softplus"
    field = field_rows_plain if plain else field_rows
    dev = t_vals.device
    rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((R,), dtype=torch.float32, device=dev)
    acc = torch.zeros((R,), dtype=torch.float32, device=dev)
    log_T = torch.zeros((R,), dtype=torch.float32, device=dev)
    ws, fracs = [], []
    for b in range(NB):
        alive_ray = alive0 & (log_T > log_eps) & (block_hit[:, b] > 0)
        alive = alive_ray.view(-1, rpt).any(dim=1).float()
        t_b = t_pad[:, b * SB:(b + 1) * SB]
        d_b = d_pad[:, b * SB:(b + 1) * SB]
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * t_b[..., None]
               ).reshape(-1, 3)
        rgb_b, sigma_b = field(net, pts, dirpart, SB, condpart, alive=alive)
        w_b, log_T = slimmarch.block_weights(sigma_b.view(R, SB), d_b, log_T,
                                             softplus)
        rgb = rgb + (w_b[..., None] * rgb_b.view(R, SB, 3)).sum(dim=1)
        depth = depth + (w_b * t_b).sum(dim=1)
        acc = acc + w_b.sum(dim=1)
        ws.append(w_b)
        fracs.append(alive.mean())
    out = _march_out(cfg, rgb, depth, acc, torch.cat(ws, dim=1), S)
    out["alive_frac"] = torch.stack(fracs).mean()
    return out


def _march(cfg: Config, net, rays_o, rays_d, viewdirs, t_vals, dnorm,
           alive0, t_end, seg, plain: bool, cond=None, sb=None, cap=None):
    """A full-field march through the pipeline the config picks: the
    two-stage march (K3) under `kernels.fused_carry=false`, else K2 or K6
    as `kernels.carry_hoist` picks; cond (R, Cc) per ray for a conditioned
    net; sb: samples a block (the proposal's block_samples); cap: the
    widths' caps (`_pass_dists`)."""
    dirpart = hoist_dirs(net, viewdirs)
    condpart = hoist_cond(net, cond)
    if not cfg.kernels.fused_carry:
        return marched_pass(net, dirpart, condpart, rays_o, rays_d, t_vals,
                            dnorm, alive0, cfg, t_end, seg=seg, plain=plain,
                            sb=sb, cap=cap)
    if cfg.kernels.carry_hoist:
        return marched_pass_slim(net, dirpart,
                                 slimmarch.hoist_rays(net, rays_o, rays_d,
                                                      condpart),
                                 t_vals, dnorm, alive0, cfg, t_end, seg=seg,
                                 plain=plain, sb=sb, cap=cap)
    return marched_pass_carry(net, dirpart, rays_o, rays_d, t_vals, dnorm,
                              alive0, cfg, t_end, seg=seg, plain=plain,
                              condpart=condpart, sb=sb, cap=cap)


def use_proposal(cfg: Config, params: dict) -> bool:
    """The σ-only proposal replaces the full coarse march when the config
    enables it, there is a fine pass, and the params carry one."""
    return (cfg.proposal.enabled and cfg.sampling.n_fine > 0
            and "proposal" in params)


def use_sigma_march(cfg: Config, occ=None) -> bool:
    """Whether the proposal pass is the σ-only single-block march (K1):
    `proposal.sigma_march`, the carry pipeline, and proposal samples (the
    budget `_budgets` gives with or without occupancy) that fit one block.
    Otherwise it is the generic proposal march."""
    n_prop, p_sb, _ = _budgets(cfg, occ)
    return (cfg.proposal.sigma_march and cfg.kernels.fused_carry
            and n_prop <= p_sb)


def _budgets(cfg: Config, occ, prop: bool = True):
    """→ (n_c, sb_c, n_fine): samples and block size of the coarse pass
    (the proposal march, or the full coarse march without one) and the
    fine samples. The render-time eval budget applies only under
    occupancy culling, as in the reference."""
    scfg, rcfg = cfg.sampling, cfg.render
    n_coarse, n_fine = scfg.n_coarse, scfg.n_fine
    if occ is not None and (rcfg.eval_n_coarse > 0 or rcfg.eval_n_fine > 0):
        n_coarse = rcfg.eval_n_coarse or n_coarse
        n_fine = (rcfg.eval_n_fine or n_fine) if n_fine > 0 else 0
    if not prop:
        return n_coarse, cfg.kernels.block_samples, n_fine
    p_sb = cfg.proposal.block_samples or cfg.kernels.block_samples
    return cfg.proposal.eval_n or n_coarse, p_sb, n_fine


def rays_per_chunk_unit(cfg: Config) -> int:
    """Chunks are whole tiles of both marches: the fine march's (halved
    for a conditioned field) and the proposal's."""
    p_sb = cfg.proposal.block_samples or cfg.kernels.block_samples
    fine = K.TILE_ROWS // (2 if (cfg.model.conditioned
                                 or cfg.model.n_latents > 0) else 1)
    return max(fine // cfg.kernels.block_samples, K.TILE_ROWS // p_sb)


def _pack_march(model, cfg: Config):
    """A field packed for K2 (x-layers hoisted), or for K6 and the
    two-stage march's K3 (x rows in the posenc operand)."""
    if cfg.kernels.fused_carry and cfg.kernels.carry_hoist:
        return slimmarch.split_hoist(model)
    return pack_params(model, hoist_x=False)


def pack_render_params(params: dict, cfg: Config, occ=None) -> dict:
    """Pack the nets the render marches, once per image: the fine net, and
    the proposal net (for K1, or for the generic proposal march's
    pipeline) or, without one, the coarse net."""
    packed = {}
    if cfg.sampling.n_fine > 0:
        packed["fine"] = _pack_march(params["fine"], cfg)
    if use_proposal(cfg, params):
        packed["proposal"] = (sigmamarch.pack_sigma(params["proposal"])
                              if use_sigma_march(cfg, occ) else
                              _pack_march(params["proposal"], cfg))
    else:
        packed["coarse"] = _pack_march(params["coarse"], cfg)
    return packed


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


def fine_march_samples(cfg: Config, occ=None, prop: bool = True) -> int:
    """Samples a ray of the fine march: the fine samples, joined with the
    coarse pass's without a proposal or under `proposal.union`, or with
    `proposal.cov_n` coverage samples. The march pads them to whole blocks
    of kernels.block_samples (f64 + cov16 → 80 → 3 blocks of 32; p64 + f64
    under union → 128 → 4 blocks)."""
    n_c, _, n_fine = _budgets(cfg, occ, prop)
    if not prop or cfg.proposal.union:
        return n_c + n_fine
    return n_fine + cfg.proposal.cov_n


def fine_samples(cfg: Config, t_c, weights, n_fine: int,
                 proposal: bool = True, strat=None):
    """Fine sample positions (sorted), in the reference's order of
    operations. From the proposal weights: edge-bin PDF, ±dilate max-pool,
    uniform floor, deterministic inverse CDF; then joined with the
    proposal samples t_c under `proposal.union`, or else with strat(cov_n)
    coverage samples under `proposal.cov_n` (strat: n → (R, n) the chunk's
    stratified samples, warped where the render warps them). From the full
    coarse march (proposal=False): mid-bin PDF, and the coarse samples
    join the fine ones."""
    pdf_bins, w_mid = _pdf_bins(t_c, weights,
                                proposal and cfg.proposal.edge_bins)
    if not proposal:
        t_f = sample_pdf(pdf_bins, w_mid, n_fine)
        return torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
    k = cfg.proposal.dilate
    if k > 0:
        w_pad = torch.cat([w_mid[:, :1].expand(-1, k), w_mid,
                           w_mid[:, -1:].expand(-1, k)], dim=1)
        w_mid = w_pad.unfold(1, 2 * k + 1, 1).amax(dim=-1)
    a = cfg.proposal.uniform_mix
    if a > 0.0:
        w_mid = (1.0 - a) * w_mid + a * w_mid.mean(dim=-1, keepdim=True)
    t_f = sample_pdf(pdf_bins, w_mid, n_fine)
    if cfg.proposal.union:
        t_f = torch.cat([t_c, t_f], dim=-1)
    elif cfg.proposal.cov_n > 0:
        if strat is None:
            raise ValueError("proposal.cov_n takes the chunk's stratified "
                             "sampler (strat)")
        t_f = torch.cat([strat(cfg.proposal.cov_n), t_f], dim=-1)
    return torch.sort(t_f, dim=-1).values


def render_rays_blockwise(params: dict, cfg: Config, rays_o, rays_d,
                          viewdirs, occ: OccupancyState = None,
                          packed: dict = None, plain: bool = False,
                          cond=None):
    """Coarse + fine render of (R,) rays, eval mode → {"coarse": dict,
    "fine": dict or None}. R must be a multiple of
    `rays_per_chunk_unit(cfg)`. params: {"fine", "proposal"} or, without
    a proposal, {"fine", "coarse"} NeRFMLPs; packed: its
    `pack_render_params` (packed here when None); cond (R, Cc): the
    per-ray cond input of conditioned nets. The coarse pass is the σ-only
    proposal march (K1), the generic proposal march, or the full coarse
    march; every march but K1's runs through the pipeline `_march`
    picks. Under `occupancy.sample_warp`, with macro-box segments and
    without `sampling.lindisp`, the stratified sets are warped onto each
    ray's occupied bins and every march caps its widths at the occupied
    runs' ends, as the reference does."""
    prop = use_proposal(cfg, params)
    n_c, sb_c, n_fine = _budgets(cfg, occ, prop)
    R = rays_o.shape[0]
    unit = rays_per_chunk_unit(cfg)
    if R % unit:
        raise ValueError(f"R={R} is not a multiple of {unit}")
    packed = packed or pack_render_params(params, cfg, occ)

    def strat(n):
        if warp:
            return warp_stratified(bins_occ, near, far, n)
        return stratified_sample(near, far, R, n, cfg.sampling.lindisp,
                                 device=rays_o.device)

    def caps(t_vals):
        return delta_caps(gap_idx, near, far, t_vals) if warp else None

    with span("fnt.rays.culling"):
        near, far, alive0, seg, t_end = culling(cfg, rays_o, rays_d, occ)
        dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        warp = (cfg.occupancy.sample_warp and seg is not None
                and not cfg.sampling.lindisp)
        if warp:
            bins_occ, gap_idx = occupancy_bins(seg, near, far,
                                               cfg.occupancy.warp_bins)
        t_c = strat(n_c)
    alive_f = alive0
    with span("fnt.rays.coarse"):
        if prop:
            pnet = packed["proposal"]
            if use_sigma_march(cfg, occ):
                out_c = sigma_march_pass(
                    pnet, sigmamarch.hoist_rays(pnet, rays_o, rays_d), t_c,
                    dnorm, alive0, cfg, t_end, seg=seg, sb=sb_c, plain=plain,
                    cap=caps(t_c))
            else:
                # the σ-only net has no view branch: its dirpart is zeros
                out_c = _march(cfg, pnet, rays_o, rays_d, viewdirs, t_c,
                               dnorm, alive0, t_end, seg, plain, sb=sb_c,
                               cap=caps(t_c))
            if cfg.proposal.cull_acc > 0.0:
                alive_f = alive0 & (out_c["acc"] > cfg.proposal.cull_acc)
        else:
            out_c = _march(cfg, packed["coarse"], rays_o, rays_d, viewdirs,
                           t_c, dnorm, alive0, t_end, seg, plain, cond,
                           cap=caps(t_c))
    if not prop and n_fine <= 0:
        return {"coarse": out_c, "fine": None}
    with span("fnt.rays.pdf"):
        t_all = fine_samples(cfg, t_c, out_c["weights"], n_fine,
                             proposal=prop, strat=strat)
    with span("fnt.rays.fine"):
        out_f = _march(cfg, packed["fine"], rays_o, rays_d, viewdirs, t_all,
                       dnorm, alive_f, t_end, seg, plain, cond,
                       cap=caps(t_all))
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
                           plain: bool = False, device=None, cond=None):
    """Whole-image blockwise render → dict of (H, W[, 3]) rgb, depth, acc,
    disp, plus chunk_live (H, W) bool: whether the pixel's chunk was
    marched (False: the whole chunk missed the box and is background).
    cond: the per-scene (Cc,) cond vector of a conditioned field. Under
    `render.ndc` the rays are mapped to NDC and the field's view
    directions stay the world directions."""
    with span("fnt.frame"):
        if device is None:
            device = next(next(iter(params.values())).parameters()).device
        with span("fnt.frame.rays"):
            rays_o, rays_d = generate_rays(H, W, focal, c2w, device=device)
            rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
            viewdirs = rays_d
            if cfg.render.ndc:
                rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
            n = rays_o.shape[0]
            tiled = H % 8 == 0 and W % 8 == 0
            inv = None
            if tiled:
                order, inv = _tile_order(H, W)
                order_t = torch.from_numpy(order).to(device)
                rays_o, rays_d = rays_o[order_t], rays_d[order_t]
                viewdirs = viewdirs[order_t]

            unit = rays_per_chunk_unit(cfg)
            chunk = max(unit, (min(cfg.render.chunk, n) // unit) * unit)
            n_chunks = -(-n // chunk)
            pad = n_chunks * chunk - n
            if pad:
                # pad origins far outside any scene box so padding joins
                # the dead-chunk / dead-tile skip; unit directions keep
                # norms finite
                fill_d = torch.zeros((pad, 3), device=device)
                fill_d[:, 2] = -1.0
                rays_o = torch.cat([rays_o, torch.full((pad, 3), 1e6,
                                                       device=device)])
                rays_d = torch.cat([rays_d, fill_d])
                viewdirs = torch.cat([viewdirs, fill_d])

        with span("fnt.frame.pack"):
            packed = pack_render_params(params, cfg, occ)
        bg = 1.0 if cfg.render.white_bkgd else 0.0
        outs = []
        for c in range(n_chunks):
            with span("fnt.chunk"):
                outs.append(_chunk(params, cfg, rays_o, rays_d, viewdirs,
                                   slice(c * chunk, (c + 1) * chunk), occ,
                                   packed, plain, cond, bg, device))

        with span("fnt.frame.unchunk"):
            inv_t = torch.from_numpy(inv).to(device) if tiled else None

            def unchunk(key):
                flat = torch.cat([o[key] for o in outs])[:n]
                if tiled:
                    flat = flat[inv_t]
                return flat.reshape((H, W) + flat.shape[1:])

            return {k: unchunk(k) for k in outs[0]}


def _chunk(params: dict, cfg: Config, rays_o, rays_d, viewdirs, sl: slice,
           occ, packed: dict, plain: bool, cond, bg: float, device) -> dict:
    """One chunk of `render_image_blockwise`: the rays of `sl` rendered
    (`render_rays_blockwise`), or, when all of them miss the occupancy
    box, the background every miss ray converges to; chunk_live says
    which."""
    o, d, v = rays_o[sl], rays_d[sl], viewdirs[sl]
    chunk = o.shape[0]
    live = True
    if occ is not None:
        with span("fnt.chunk.cull"):
            _, _, hit = ray_aabb_intersect(o, d, occ.box_min, occ.box_max,
                                           cfg.render.near, cfg.render.far)
            live = bool(hit.any())
    if live:
        c = None if cond is None else cond.expand(chunk, cond.shape[-1])
        with span("fnt.chunk.march"):
            f = render_rays_blockwise(params, cfg, o, d, v, occ=occ,
                                      packed=packed, plain=plain, cond=c)
        head = f["fine"] if f["fine"] is not None else f["coarse"]
        out = {k: head[k] for k in ("rgb", "depth", "acc", "disp")}
    else:
        # the exact output every miss ray converges to
        out = {"rgb": torch.full((chunk, 3), bg, device=device),
               "depth": torch.zeros((chunk,), device=device),
               "acc": torch.zeros((chunk,), device=device),
               "disp": torch.full((chunk,), 1e10, device=device)}
    out["chunk_live"] = torch.full((chunk,), live, dtype=torch.bool,
                                   device=device)
    return out
