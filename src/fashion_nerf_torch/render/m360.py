"""mip-NeRF 360's render of a chunk of rays (Barron et al., CVPR 2022), for
configs with `model.ipe_deg > 0`; `render_image_blockwise` calls it for
every chunk of the frame (its frame loop, ray order, chunking and
unchunking are those of every preset).

Per chunk, as published, at evaluation:
1. the rays' cone radius ṙ (core/cones.py, from the camera's focal);
2. proposal round 0: `proposal.eval_n` intervals evenly spaced in s
   (g(x) = 1/x between `render.near` and `render.far`), the contracted cone
   Gaussians, their IPE and the proposal MLP through K7, the interval
   weights;
3. the weights' histogram in s resampled to `proposal.eval_n` intervals
   (`core.sampling.resample_intervals`: evenly spaced quantiles);
4. proposal round 1 on them (the same net);
5. resampled to `sampling.n_fine` intervals;
6. the NeRF MLP through K7 on those;
7. α-compositing over real distances: density softplus(raw − 1), the
   weights αᵢ Πⱼ<ᵢ(1 − αⱼ) with αᵢ = 1 − exp(−density · Δtᵢ · ‖d‖), rgb
   = Σ w c plus the background over 1 − Σ w.
Every sample of every ray is evaluated: no culling, no early termination.
Host ranges: "fnt.rays.prop" (each proposal round), "fnt.rays.resample",
"fnt.rays.nerf" and, inside the rounds, "fnt.rays.cones" (the Gaussians
and the contraction; the IPE is K7's own first kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fashion_nerf_torch.core.cones import cone_gaussians, s_to_t
from fashion_nerf_torch.core.sampling import resample_intervals
from fashion_nerf_torch.kernels.widefield import (dir_term, pack_wide,
                                                  wide_rows)
from fashion_nerf_torch.models.mipnerf360 import DENSITY_BIAS, MipMLP
from fashion_nerf_torch.trace import span

PROPOSAL_ROUNDS = 2


def takes(params: dict) -> bool:
    """Whether a frame's nets are mip-NeRF 360's (the MipMLPs of a config
    with `model.ipe_deg > 0`), which only this chunk function renders."""
    return isinstance(params.get("fine"), MipMLP)


def pack_m360(params: dict, cfg) -> dict:
    """{"proposal", "fine"} MipMLPs → their K7 packings (rounded to bf16
    unless `model.compute_dtype` is float32)."""
    bf16 = cfg.model.compute_dtype == "bfloat16"
    return {k: pack_wide(params[k], bf16) for k in ("proposal", "fine")}


def interval_weights(sigma_raw, tdist, dnorm):
    """Compositing weights of intervals (R, S) from raw σ, the edges tdist
    (R, S+1) and ‖d‖ (R, 1)."""
    dd = F.softplus(sigma_raw + DENSITY_BIAS) * (
        tdist[:, 1:] - tdist[:, :-1]) * dnorm
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[:, :1]),
                                  torch.cumsum(dd[:, :-1], dim=1)], dim=1))
    return (1.0 - torch.exp(-dd)) * trans


def _gaussians(rays_o, rays_d, radius, sdist, cfg):
    tdist = s_to_t(sdist, cfg.render.near, cfg.render.far)
    with span("fnt.rays.cones"):
        mean, var = cone_gaussians(rays_o, rays_d, radius, tdist)
    return (tdist, mean.reshape(-1, 3).contiguous(),
            var.reshape(-1, 3).contiguous())


def render_rays_m360(params: dict, cfg, rays_o, rays_d, viewdirs,
                     radius: float, packed: dict = None) -> dict:
    """One chunk of R rays (a multiple of 64) → dict rgb (R, 3) with the
    background, depth (the weights' mean interval midpoint), acc, disp.
    params: {"proposal", "fine"} MipMLPs; packed: their `pack_m360` (packed
    here when None)."""
    if not cfg.sampling.lindisp:
        raise ValueError("mip-NeRF 360 spaces its samples in disparity: "
                         "sampling.lindisp must be true")
    packed = packed or pack_m360(params, cfg)
    R = rays_o.shape[0]
    n_p, n_f = cfg.proposal.eval_n, cfg.sampling.n_fine
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    sdist = torch.linspace(0.0, 1.0, n_p + 1, device=rays_o.device).expand(
        R, n_p + 1)
    for r in range(PROPOSAL_ROUNDS):
        with span("fnt.rays.prop"):
            tdist, mean, var = _gaussians(rays_o, rays_d, radius, sdist, cfg)
            _, sigma = wide_rows(packed["proposal"], mean, var, None, n_p)
            w = interval_weights(sigma.view(R, n_p), tdist, dnorm)
        with span("fnt.rays.resample"):
            n = n_p if r + 1 < PROPOSAL_ROUNDS else n_f
            sdist = resample_intervals(sdist, w, n)
    with span("fnt.rays.nerf"):
        tdist, mean, var = _gaussians(rays_o, rays_d, radius, sdist, cfg)
        net = packed["fine"]
        rgb_s, sigma = wide_rows(net, mean, var,
                                 dir_term(net, viewdirs).contiguous(), n_f)
        w = interval_weights(sigma.view(R, n_f), tdist, dnorm)
        rgb = torch.sum(w[..., None] * rgb_s.view(R, n_f, 3), dim=1)
        acc = w.sum(dim=1)
        if cfg.render.white_bkgd:
            rgb = rgb + (1.0 - acc[:, None])
        depth = torch.sum(w * 0.5 * (tdist[:, 1:] + tdist[:, :-1]), dim=1)
        disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10),
                                 min=1e-10)
    return {"rgb": rgb, "depth": depth, "acc": acc, "disp": disp}
