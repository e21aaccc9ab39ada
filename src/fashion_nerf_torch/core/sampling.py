"""Stratified and hierarchical sampling along rays.

Counterpart of `fashion_nerf.core.sampling`. The render path is
deterministic (no jitter, evenly spaced quantiles); training jitters the
stratified bins and draws random quantiles. Every draw comes from an
explicit `torch.Generator`.
"""

from __future__ import annotations

import torch


def stratified_sample(near, far, n_rays: int, n_samples: int,
                      lindisp: bool = False, device=None, *,
                      perturb: bool = False, generator=None):
    """Linspace over [near, far] → (n_rays, n_samples) f32; with perturb,
    one uniform jitter per bin (drawn from `generator`).

    near, far: scalars or (n_rays,) per-ray bounds."""
    near = torch.as_tensor(near, dtype=torch.float32, device=device)
    device = near.device
    far = torch.as_tensor(far, dtype=torch.float32, device=device)
    near = near.expand(n_rays)[:, None]
    far = far.expand(n_rays)[:, None]
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    if perturb:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        u = torch.rand(z.shape, generator=generator, device=device)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(bins, weights, n_samples: int, eps: float = 1e-5, *,
               det: bool = True, generator=None, quantiles=None):
    """Inverse-CDF sampling from a piecewise-constant PDF.

    bins (R, B+1) edges, weights (R, B) mass → (R, n_samples), not sorted.
    Quantiles: `quantiles` (R, n_samples) when given; else evenly spaced
    in [0, 1] (det) or uniform draws from `generator`. Weights get an `eps`
    floor; a quantile u ≥ cdf[-1] clamps to the last edge."""
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)   # (R, B+1)
    R, n_edges = cdf.shape
    if quantiles is not None:
        u = quantiles.to(cdf.dtype).contiguous()
    elif det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                           device=cdf.device).expand(R, n_samples).contiguous()
    else:
        u = torch.rand((R, n_samples), generator=generator,
                       device=cdf.device)
    # last edge with cdf ≤ u, first edge with cdf > u (clamped to the end)
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = above - 1
    above = above.clamp(max=n_edges - 1)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bin_below = torch.gather(bins, 1, below)
    bin_above = torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    frac = (u - cdf_below) / denom
    return bin_below + frac * (bin_above - bin_below)
