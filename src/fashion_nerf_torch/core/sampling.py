"""Stratified and hierarchical sampling along rays.

Counterpart of `fashion_nerf.core.sampling`. The render path is
deterministic (no jitter, evenly spaced quantiles); training jitters the
stratified bins and draws random quantiles. Every draw comes from an
explicit `torch.Generator`, or a data-parallel rank's rows of one
(`prng.RowDraws`).
"""

from __future__ import annotations

import torch

from fashion_nerf_torch.prng import rand


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
        u = rand(z.shape, generator, device)
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
        u = rand((R, n_samples), generator, cdf.device)
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


def resample_intervals(edges, weights, n: int, eps: float = 1e-5,
                       jitter=None):
    """mip-NeRF 360's resampling of a step function in s: the centres at
    the quantiles (k + 0.5)/n of the histogram (edges (R, B+1), mass
    weights (R, B) with an `eps` floor, `sample_pdf`), the new edges
    halfway between neighbouring centres, and the first and last edge the
    reflections of their neighbouring midpoints about the end centres,
    clamped to [0, 1] → (R, n+1) edges. jitter (R, 1) in [0, 1): training's
    quantiles (k + jitter)/n, one offset a ray, in place of the midpoints."""
    R = edges.shape[0]
    k = torch.arange(n, dtype=torch.float32, device=edges.device)
    if jitter is None:
        u = ((k + 0.5) / n).expand(R, n)
    else:
        u = (k + jitter) / n
    c = sample_pdf(edges, weights, n, eps, quantiles=u)
    mid = 0.5 * (c[:, 1:] + c[:, :-1])
    first = torch.clamp(2.0 * c[:, :1] - mid[:, :1], min=0.0)
    last = torch.clamp(2.0 * c[:, -1:] - mid[:, -1:], max=1.0)
    return torch.cat([first, mid, last], dim=-1)


def occupancy_bins(seg, t_lo, t_hi, nbins: int):
    """Per-ray occupancy on a grid of nbins equal t-bins over [t_lo, t_hi]
    (the occupancy-warped sampling's substrate, `occupancy.sample_warp`).

    seg: (seg_lo, seg_hi, seg_hit) (R, K) per-ray macro-box segments
    (`core.occupancy.ray_multi_aabb`); t_lo, t_hi: scalars or (R,).
    → occ (R, nbins) f32, 1 where the bin overlaps an occupied segment;
    gap_idx (R, nbins) f32, the index of the first unoccupied bin at or
    after each bin (the end edge of the occupied run holding it; itself
    for an unoccupied bin, nbins when the run reaches t_hi)."""
    seg_lo, seg_hi, seg_hit = seg
    R = seg_lo.shape[0]
    dev = seg_lo.device
    t_lo = torch.as_tensor(t_lo, dtype=torch.float32, device=dev).expand(R)
    t_hi = torch.as_tensor(t_hi, dtype=torch.float32, device=dev).expand(R)
    step = (t_hi - t_lo)[:, None] / nbins
    i = torch.arange(nbins, dtype=torch.float32, device=dev)
    e0 = t_lo[:, None] + step * i
    e1 = e0 + step
    occ = ((seg_lo[:, None, :] < e1[..., None])
           & (seg_hi[:, None, :] > e0[..., None])
           & seg_hit[:, None, :]).any(dim=-1)
    # first unoccupied bin at or after i: a running min from the far end
    own = torch.where(occ, torch.full_like(e0, float(nbins)), i.expand(R, -1))
    gap_idx = torch.cummin(own.flip(1), dim=1).values.flip(1)
    return occ.float(), gap_idx


def warp_stratified(occ, t_lo, t_hi, n_samples: int):
    """Deterministic samples warped onto the occupied bins: the midpoint
    quantiles (k + 0.5)/n of the bins' occupancy mass, so that equal
    occupied length lies between neighbours and no sample sits on a run's
    end edge. With every bin occupied, (midpoint-offset) uniform samples
    over [t_lo, t_hi]. → (R, n_samples) increasing t."""
    R, nbins = occ.shape
    dev = occ.device
    t_lo = torch.as_tensor(t_lo, dtype=torch.float32, device=dev).expand(R)
    t_hi = torch.as_tensor(t_hi, dtype=torch.float32, device=dev).expand(R)
    step = (t_hi - t_lo)[:, None] / nbins
    edges = t_lo[:, None] + step * torch.arange(nbins + 1,
                                                dtype=torch.float32,
                                                device=dev)
    u = (torch.arange(n_samples, dtype=torch.float32, device=dev) + 0.5) \
        / n_samples
    return sample_pdf(edges, occ, n_samples, quantiles=u.expand(R, -1))


def delta_caps(gap_idx, t_lo, t_hi, t_vals):
    """Per-sample cap on the integration width: the t of the end edge of
    the occupied run that holds each sample (a sample in an unoccupied bin
    gets its bin's end), so that no interval spans a culled gap; the march
    takes δ = min(t_next, max(cap, t)) − t. → (R, S) t."""
    R, nbins = gap_idx.shape
    dev = gap_idx.device
    t_lo = torch.as_tensor(t_lo, dtype=torch.float32, device=dev).expand(R)
    t_hi = torch.as_tensor(t_hi, dtype=torch.float32, device=dev).expand(R)
    step = ((t_hi - t_lo) / nbins)[:, None]
    denom = torch.where(step > 0, step, torch.ones_like(step))
    bi = torch.clamp(torch.floor((t_vals - t_lo[:, None]) / denom), 0,
                     nbins - 1).long()
    return t_lo[:, None] + torch.gather(gap_idx, 1, bi) * step
