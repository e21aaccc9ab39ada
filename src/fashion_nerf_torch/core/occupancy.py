"""Occupancy-driven empty-space culling; counterpart of
`fashion_nerf.core.occupancy`.

A σ sweep of the trained fine field on a G³ lattice gives a binary grid,
reduced to a tight AABB and to macro³ sub-AABBs. Rays are slab-tested
against them: rays that miss skip the field, rays that hit concentrate
their sample budget inside their occupied interval, and sample blocks that
overlap no occupied box are culled in the marches. The blockwise render
tests its rays against the occupied boxes alone (`occupied_boxes`, once an
image) through kernel K8 (kernels/boxcull.py), which recomputes the per-box
segments from a `BoxSegments` handle instead of materialising them; the
compositions here are its plain versions. Training rebuilds the
grid from the live nets (train/loop.py::refresh_occupancy) and composites
missing rays with `cull_background`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


class OccupancyState(NamedTuple):
    """box_min/box_max (3,) global AABB; grid (G,G,G) bool;
    boxes_min/boxes_max (K,3) and boxes_occ (K,) bool for the K = macro³
    sub-boxes (rows with boxes_occ False are meaningless)."""
    box_min: torch.Tensor
    box_max: torch.Tensor
    grid: torch.Tensor
    boxes_min: torch.Tensor
    boxes_max: torch.Tensor
    boxes_occ: torch.Tensor


def build_occupancy(field: Callable, world_min, world_max,
                    resolution: int = 64, sigma_threshold: float = 1e-2,
                    margin_cells: int = 1, chunk: int = 65536,
                    sigma_activation: str = "relu", macro: int = 4,
                    device=None) -> OccupancyState:
    """Sample σ at the G³ cell centers and reduce to culling state.

    field: bound field (pts (R,S,3), viewdirs (R,3)) → (rgb, σ raw), called
    once per `chunk` lattice points with a dummy view direction."""
    g = resolution
    world_min = torch.as_tensor(world_min, dtype=torch.float32,
                                device=device).expand(3)
    device = world_min.device
    world_max = torch.as_tensor(world_max, dtype=torch.float32,
                                device=device).expand(3)
    cell = (world_max - world_min) / g
    ar = torch.arange(g, dtype=torch.float32, device=device) + 0.5
    ax = [world_min[i] + cell[i] * ar for i in range(3)]
    xx, yy, zz = torch.meshgrid(*ax, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)        # (G³, 3)

    n = pts.shape[0]
    rows = max(1, chunk // g)
    n_chunks = -(-n // (rows * g))
    pad = n_chunks * rows * g - n
    pts = F.pad(pts, (0, 0, 0, pad)).reshape(n_chunks, rows, g, 3)
    dummy_dirs = torch.tensor([0.0, 0.0, -1.0], device=device).expand(
        rows, 3).contiguous()
    sigma_raw = torch.cat([field(p, dummy_dirs)[1].reshape(-1)
                           for p in pts])[:n]
    density = (F.softplus(sigma_raw) if sigma_activation == "softplus"
               else torch.relu(sigma_raw))
    grid = (density > sigma_threshold).reshape(g, g, g)

    any_occ = bool(grid.any())
    if any_occ:
        idx = grid.nonzero()
        lo_i = idx.min(dim=0).values - margin_cells
        hi_i = idx.max(dim=0).values + 1 + margin_cells
        box_min = world_min + cell * lo_i.clamp(0, g).float()
        box_max = world_min + cell * hi_i.clamp(0, g).float()
    else:
        # empty grid: culling degrades to a no-op over the scan box
        box_min, box_max = world_min.clone(), world_max.clone()
    bmin, bmax, bocc = _macro_boxes(grid, world_min, cell, g, max(macro, 1),
                                    margin_cells, any_occ, box_min, box_max)
    return OccupancyState(box_min=box_min, box_max=box_max, grid=grid,
                          boxes_min=bmin, boxes_max=bmax, boxes_occ=bocc)


def _macro_boxes(grid, world_min, cell, g: int, k: int, margin_cells: int,
                 any_occ: bool, fallback_min, fallback_max):
    """Reduce the (g,g,g) grid to k³ macro cells, each with a tight sub-AABB
    of its occupied cells after a (2·margin+1)³ max-pool dilation (so halos
    cross macro boundaries). An empty grid gives one full-extent box."""
    if g % k:
        raise ValueError(f"resolution {g} is not a multiple of macro {k}")
    m = g // k
    if margin_cells > 0:
        w = 2 * margin_cells + 1
        grid = F.max_pool3d(grid[None, None].float(), w, stride=1,
                            padding=margin_cells)[0, 0] > 0
    sub = grid.reshape(k, m, k, m, k, m)
    occ_k = sub.any(dim=5).any(dim=3).any(dim=1).reshape(-1)       # (K,)
    lo_list, hi_list = [], []
    for d, ax in enumerate((1, 3, 5)):
        shape = [1] * 6
        shape[ax] = m
        ids = torch.arange(m, device=grid.device).reshape(shape)
        big = torch.full_like(sub, m, dtype=torch.long)
        lo = torch.where(sub, ids, big).amin(dim=(1, 3, 5))          # (k,k,k)
        hi = torch.where(sub, ids, -1).amax(dim=(1, 3, 5))
        bshape = [1, 1, 1]
        bshape[d] = k
        base = (torch.arange(k, device=grid.device) * m).reshape(bshape)
        lo_list.append((base + lo.clamp(0, m)).reshape(-1))
        hi_list.append((base + (hi + 1).clamp(0, m)).reshape(-1))
    lo_i = torch.stack(lo_list, dim=-1).float()                     # (K, 3)
    hi_i = torch.stack(hi_list, dim=-1).float()
    bmin = world_min[None, :] + cell[None, :] * lo_i
    bmax = world_min[None, :] + cell[None, :] * hi_i
    if not any_occ:
        bmin = fallback_min.expand_as(bmin).clone()
        bmax = fallback_max.expand_as(bmax).clone()
        occ_k = torch.zeros_like(occ_k)
        occ_k[0] = True
    return bmin, bmax, occ_k


def effective_margin_cells(ocfg) -> int:
    """max(margin_cells, ceil(margin_world / cell width)) — the physical
    halo must not shrink when the resolution grows."""
    cell_w = (float(ocfg.world_max) - float(ocfg.world_min)) \
        / ocfg.resolution
    world = (int(math.ceil(ocfg.margin_world / cell_w))
             if ocfg.margin_world > 0 else 0)
    return max(ocfg.margin_cells, world)


def build_from_config(cfg, field: Callable, device=None,
                      cond=None) -> OccupancyState:
    """Config-driven build; `field` is the BOUND fine field. cond: the
    per-scene cond vector (Cc,) of a conditioned field, whose density
    depends on it: the field is then called as field(pts, viewdirs, cond
    (R, Cc)), and the grid holds for this cond only."""
    ocfg = cfg.occupancy
    if cond is not None:
        unbound = field

        def field(pts, dirs):
            return unbound(pts, dirs, cond.expand(pts.shape[0],
                                                  cond.shape[-1]))
    return build_occupancy(
        field, ocfg.world_min, ocfg.world_max,
        resolution=ocfg.resolution,
        sigma_threshold=ocfg.sigma_threshold,
        margin_cells=effective_margin_cells(ocfg),
        sigma_activation=cfg.model.sigma_activation,
        macro=ocfg.macro, device=device)


def _safe_inv(rays_d):
    tiny = torch.where(rays_d < 0, -1e-10, 1e-10)
    return 1.0 / torch.where(rays_d.abs() < 1e-10, tiny, rays_d)


def ray_aabb_intersect(rays_o, rays_d, box_min, box_max, near, far):
    """Slab test of (R,3) rays against one AABB, clipped to [near, far].

    → t_lo, t_hi (R,) (both = far on a miss), hit (R,) bool."""
    inv = _safe_inv(rays_d)
    t0 = (box_min[None, :] - rays_o) * inv
    t1 = (box_max[None, :] - rays_o) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    t_lo = t_near.clamp(near, far)
    t_hi = t_far.clamp(near, far)
    hit = t_hi > t_lo
    far_t = torch.full_like(t_lo, far)
    return (torch.where(hit, t_lo, far_t), torch.where(hit, t_hi, far_t),
            hit)


def ray_multi_aabb(rays_o, rays_d, occ: OccupancyState, near, far):
    """Slab test of (R,3) rays against the K macro boxes.

    → t_lo, t_hi (R,) union interval over hit boxes (far on a miss),
    hit (R,), seg_lo, seg_hi, seg_hit (R, K) per-box entry/exit/hit."""
    return ray_multi_aabb_inv(rays_o, _safe_inv(rays_d), occ.boxes_min,
                              occ.boxes_max, near, far, occ.boxes_occ)


def ray_multi_aabb_inv(rays_o, inv, boxes_min, boxes_max, near, far,
                       boxes_occ=None):
    """`ray_multi_aabb` from the reciprocal directions inv (R,3)
    (`_safe_inv`) against boxes_min, boxes_max (K,3) with occupancy
    flags boxes_occ (K,), or all occupied when None: the plain composition
    K8 (kernels/boxcull.py) is held to."""
    t_near = t_far = None
    for d in range(3):
        o_d, i_d = rays_o[:, d:d + 1], inv[:, d:d + 1]
        t0 = (boxes_min[None, :, d] - o_d) * i_d                    # (R, K)
        t1 = (boxes_max[None, :, d] - o_d) * i_d
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = lo if t_near is None else torch.maximum(t_near, lo)
        t_far = hi if t_far is None else torch.minimum(t_far, hi)
    seg_lo = t_near.clamp(near, far)
    seg_hi = t_far.clamp(near, far)
    seg_hit = seg_hi > seg_lo
    if boxes_occ is not None:
        seg_hit = seg_hit & boxes_occ[None, :]
    hit = seg_hit.any(dim=1)
    far_t = torch.full_like(seg_lo, far)
    near_t = torch.full_like(seg_lo, near)
    t_lo = torch.where(seg_hit, seg_lo, far_t).amin(dim=1)
    t_hi = torch.where(seg_hit, seg_hi, near_t).amax(dim=1)
    far_r = far_t[:, 0]
    return (torch.where(hit, t_lo, far_r), torch.where(hit, t_hi, far_r),
            hit, seg_lo, seg_hi, seg_hit)


def occupied_boxes(occ: OccupancyState):
    """→ lo, hi (n, 3) f32, contiguous: the occupied macro boxes alone, in
    their order (one host sync: n is read back). Culling against them gives
    what culling against all K with their flags gives (the union and the
    flags are mins, maxes and ors over the hit boxes). With none occupied,
    one box of zero volume, which no ray enters (its clamped exit is never
    above its entry)."""
    idx = occ.boxes_occ.nonzero()[:, 0]
    if idx.numel() == 0:
        idx = idx.new_zeros(1)
        return occ.boxes_min[idx], occ.boxes_min[idx]
    return occ.boxes_min[idx], occ.boxes_max[idx]


def block_overlap(t_pad, SB: int, seg, R: int, NB: int):
    """(R, NB) f32: 1 where block b's t-range [t_pad[:, b·SB], max over its
    SB samples] overlaps a segment of seg = (seg_lo, seg_hi, seg_hit)
    (R, K) that the ray hits (a block ends at the max over the block, so
    zero-padded tails never end one)."""
    seg_lo, seg_hi, seg_hit = seg
    tb = t_pad.reshape(R, NB, SB)
    t_starts = tb[:, :, 0]
    t_ends = tb.amax(dim=2)
    overlap = ((seg_lo[:, None, :] <= t_ends[..., None])
               & (seg_hi[:, None, :] >= t_starts[..., None])
               & seg_hit[:, None, :])
    return overlap.any(dim=-1).float()


class BoxSegments(NamedTuple):
    """A chunk's per-(ray, box) segments left unmaterialised: the rays,
    their reciprocal directions (`_safe_inv`), the boxes lo, hi (n, 3)
    (`occupied_boxes`) and the [near, far] clip. K8 (kernels/boxcull.py)
    computes the union interval and the marches' block flags from it, so
    no (R, n) tensor is written."""
    rays_o: torch.Tensor
    inv_d: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    near: float
    far: float


def box_segments(rays_o, rays_d, lo, hi, near, far) -> BoxSegments:
    """The `BoxSegments` handle of (R,3) rays against boxes lo, hi (n,3),
    clipped to [near, far]."""
    return BoxSegments(rays_o.contiguous(), _safe_inv(rays_d), lo, hi,
                       near, far)


def cull_background(out: dict, hit, white_bkgd: bool) -> dict:
    """Per-ray outputs of rays that miss the occupancy box replaced by the
    background the dense path converges to: rgb white (or black), acc,
    weights and depth 0, disp 1e10."""
    h = hit[:, None]
    bg = 1.0 if white_bkgd else 0.0
    zero = torch.zeros((), dtype=out["acc"].dtype, device=hit.device)
    return {
        "rgb": torch.where(h, out["rgb"], zero + bg),
        "depth": torch.where(hit, out["depth"], zero),
        "acc": torch.where(hit, out["acc"], zero),
        "weights": torch.where(h, out["weights"], zero),
        "disp": torch.where(hit, out["disp"], zero + 1e10),
    }
