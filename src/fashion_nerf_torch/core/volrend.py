"""Quadrature volume rendering; counterpart of `fashion_nerf.core.volrend`.

δᵢ = (tᵢ₊₁ − tᵢ)·‖d‖;  αᵢ = 1 − exp(−σᵢδᵢ);  Tᵢ = ∏_{j<i}(1 − αⱼ);
wᵢ = Tᵢαᵢ;  C = Σwᵢcᵢ;  depth = Σwᵢtᵢ;  acc = Σwᵢ; white bkgd: C + (1 − acc).

The blockwise marches (kernels/sigmamarch.py, kernels/slimmarch.py) equal
this at early-termination ε = 0 up to their log-space transmittance.
"""

from __future__ import annotations

import torch

from fashion_nerf_torch.prng import randn

_INF_DIST = 1e10


def volume_render(rgb, sigma, t_vals, rays_d, white_bkgd: bool = False,
                  sigma_activation: str = "relu", t_end=None,
                  raw_noise_std: float = 0.0, generator=None):
    """rgb (R,S,3) post-sigmoid, sigma (R,S) raw, t_vals (R,S), rays_d (R,3)
    → dict rgb (R,3), depth (R,), acc (R,), weights (R,S), disp (R,).

    t_end: None → infinite last interval; scalar or (R,) → finite bound.
    raw_noise_std > 0 adds Gaussian noise drawn from `generator` to σ
    before the activation (a training regularizer)."""
    dists = t_vals[:, 1:] - t_vals[:, :-1]
    if t_end is None:
        last = torch.full_like(t_vals[:, :1], _INF_DIST)
    else:
        t_end = torch.as_tensor(t_end, dtype=t_vals.dtype,
                                device=t_vals.device).expand(t_vals.shape[0])
        last = torch.clamp(t_end[:, None] - t_vals[:, -1:], min=0.0)
    dists = torch.cat([dists, last], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    if raw_noise_std > 0.0:
        sigma = sigma + randn(sigma.shape, generator,
                              sigma.device) * raw_noise_std
    density = (torch.nn.functional.softplus(sigma)
               if sigma_activation == "softplus" else torch.relu(sigma))
    alpha = 1.0 - torch.exp(-density * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * t_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb": rgb_map, "depth": depth_map, "acc": acc_map,
            "weights": weights, "disp": disp_map}
