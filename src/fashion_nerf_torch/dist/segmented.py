"""`segmented_ray_scan`: volume rendering with the sample axis split over
ranks; counterpart of `fashion_nerf.dist.segmented`.

The transmittance product Tᵢ = ∏_{j<i}(1 − αⱼ) splits across segments of
the samples as blockwise attention's softmax does: each rank renders its
own segment and returns partials (rgb, depth, acc and the segment's
log-transmittance total); an exclusive prefix of the totals over the
segments rescales each segment's partials, and their sum is the ray's
render:

    rgb = Σ_seg T_before(seg) · rgb_seg,   T_before = exp(Σ_{s<seg} log T_s)

The reference runs this in plain XLA, outside any Pallas kernel; this is
plain torch. Its collectives are the ones gloo takes CUDA tensors in: the
reference's ring shift of each segment's first t is an all_gather of the
(n_seg, R) firsts, the prefix an all_gather of the totals, the sum an
all_reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_INF_DIST = 1e10
_LOG_FLOOR = -23.025851


def _segment_render(rgb, sigma, t_vals, dists):
    """Partials of one segment: (rgb (R,3), depth (R,), acc (R,),
    log-transmittance total (R,))."""
    x = torch.relu(sigma) * dists
    alpha = 1.0 - torch.exp(-x)
    log_om = torch.clamp(-x, min=_LOG_FLOOR)
    log_t = torch.cumsum(log_om, dim=-1) - log_om
    weights = alpha * torch.exp(log_t)
    return ((weights[..., None] * rgb).sum(-2), (weights * t_vals).sum(-1),
            weights.sum(-1), log_om.sum(-1))


def _group(mesh_or_group, axis: str):
    if mesh_or_group is None or isinstance(mesh_or_group, dist.ProcessGroup):
        return mesh_or_group
    return mesh_or_group.get_group(axis)


def _all_gather(t, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def segmented_ray_scan(mesh_or_group, rgb, sigma, t_vals, rays_d,
                       white_bkgd: bool = False, axis: str = "sp") -> dict:
    """Volume-render rays whose samples are split over the ranks of
    `axis` (a DeviceMesh dim), or of a process group (None: the world).

    Each rank passes its own segment, in rank order along the ray: rgb
    (R, S/n, 3), sigma (R, S/n) raw, t_vals (R, S/n); rays_d (R, 3) is the
    same on every rank. Every rank returns {"rgb", "depth", "acc"} of the
    whole rays, equal to `core.volrend.volume_render` of the joined
    samples up to the order of float sums (its +1e-10 in 1 − α aside)."""
    group = _group(mesh_or_group, axis)
    n_seg, seg = dist.get_world_size(group), dist.get_rank(group)
    firsts = _all_gather(t_vals[:, 0], group)                  # (n_seg, R)
    last = (torch.full_like(t_vals[:, :1], _INF_DIST) if seg == n_seg - 1
            else firsts[seg + 1][:, None] - t_vals[:, -1:])
    dists = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], last], dim=1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rgb_p, depth_p, acc_p, logt_p = _segment_render(rgb, sigma, t_vals,
                                                    dists)
    before = _all_gather(logt_p, group)[:seg].sum(0)           # (R,)
    scale = torch.exp(before)[:, None]
    out = torch.cat([rgb_p, depth_p[:, None], acc_p[:, None]], 1) * scale
    dist.all_reduce(out, group=group)
    rgb_map, depth, acc = out[:, :3], out[:, 3], out[:, 4]
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    return {"rgb": rgb_map, "depth": depth, "acc": acc}
