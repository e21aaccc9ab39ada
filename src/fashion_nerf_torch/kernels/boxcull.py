"""Occupancy culling against the macro boxes (kernel K8, csrc/boxcull.cu)
and its plain versions.

No TPU kernel: the reference culls in XLA glue
(`fashion_nerf.core.occupancy.ray_multi_aabb`,
`fashion_nerf.render.blockwise._block_hit_flags`), which XLA fuses. Run
eagerly, the same torch ops write and read back (R, K) and (R, NB, K)
intermediates for every chunk; K8 computes per ray, and per (ray, block),
straight from the rays and the boxes, so none is written.

Both entries take a `BoxSegments` handle: the rays, their reciprocal
directions from `_safe_inv` (so the reciprocal is torch's own), the
occupied boxes (`occupied_boxes`) and the [near, far] clip.

- `box_cull`: the union interval near, far (R,) and hit (R,) bool:
  `ray_multi_aabb`'s first three outputs.
- `block_hit`: (R, NB) f32, 1 where a block's range [first sample, max
  over the block] of t_pad overlaps a box the ray hits: `block_overlap` of
  the segments.

Each gives what its plain version gives (the same f32 operations in the
same order) and counts under LAUNCHES "box_cull" and "block_hit".
"""

from __future__ import annotations

import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.occupancy import (BoxSegments, block_overlap,
                                               ray_multi_aabb_inv)
from fashion_nerf_torch.trace import span


def segments_plain(seg: BoxSegments):
    """The handle's segments materialised: `ray_multi_aabb_inv` on its
    boxes → near, far, hit (R,), seg_lo, seg_hi, seg_hit (R, n)."""
    return ray_multi_aabb_inv(seg.rays_o, seg.inv_d, seg.lo, seg.hi,
                              seg.near, seg.far)


def box_cull_plain(seg: BoxSegments):
    """Plain version of `box_cull`: the torch composition."""
    return segments_plain(seg)[:3]


def block_hit_plain(t_pad, SB: int, seg: BoxSegments):
    """Plain version of `block_hit`: the segments materialised, then their
    overlaps with the blocks."""
    R, S = t_pad.shape
    return block_overlap(t_pad, SB, segments_plain(seg)[3:], R, S // SB)


def _check(seg: BoxSegments) -> tuple:
    """→ (R, n), raising unless the handle is what K8 takes."""
    R, n = seg.rays_o.shape[0], seg.lo.shape[0]
    K.check(seg.rays_o, "rays_o", torch.float32, (R, 3))
    K.check(seg.inv_d, "inv_d", torch.float32, (R, 3))
    K.check(seg.lo, "boxes lo", torch.float32, (n, 3))
    K.check(seg.hi, "boxes hi", torch.float32, (n, 3))
    if n < 1:
        raise ValueError("no boxes (occupied_boxes gives at least one)")
    return R, n


def _ptrs(seg: BoxSegments) -> list:
    return [seg.rays_o.data_ptr(), seg.inv_d.data_ptr(), seg.lo.data_ptr(),
            seg.hi.data_ptr()]


def box_cull(seg: BoxSegments):
    """→ near, far (R,) f32 (far, far on a miss), hit (R,) bool. CPU
    tensors: plain version; CUDA tensors: kernel K8."""
    dev = K.on_cuda(seg.rays_o, seg.inv_d, seg.lo, seg.hi)
    if dev is None:
        return box_cull_plain(seg)
    with span("fnt.kernel.box_cull"):
        R, n = _check(seg)
        t = torch.empty((2, R), dtype=torch.float32, device=dev)
        hit = torch.empty((R,), dtype=torch.bool, device=dev)
        if R == 0:
            return t[0], t[1], hit
        code = K.library().fnt_box_cull(
            *_ptrs(seg), t[0].data_ptr(), t[1].data_ptr(), hit.data_ptr(),
            R, n, float(seg.near), float(seg.far), *K.launch_args(dev))
        K.raise_on_error(code, "fnt_box_cull")
        K.LAUNCHES["box_cull"] += 1
        return t[0], t[1], hit


def block_hit(t_pad, SB: int, seg: BoxSegments):
    """t_pad (R, NB·SB) → (R, NB) f32 block flags. CPU tensors: plain
    version; CUDA tensors: kernel K8."""
    dev = K.on_cuda(t_pad, seg.rays_o, seg.inv_d, seg.lo, seg.hi)
    if dev is None:
        return block_hit_plain(t_pad, SB, seg)
    with span("fnt.kernel.block_hit"):
        R, n = _check(seg)
        NB = t_pad.shape[-1] // SB if SB > 0 else 0
        if NB < 1 or NB * SB != t_pad.shape[-1]:
            raise ValueError(f"t_pad {tuple(t_pad.shape)} is not whole "
                             f"blocks of {SB} samples")
        K.check(t_pad, "t_pad", torch.float32, (R, NB * SB))
        flags = torch.empty((R, NB), dtype=torch.float32, device=dev)
        if R == 0:
            return flags
        code = K.library().fnt_block_hit(
            t_pad.data_ptr(), *_ptrs(seg), flags.data_ptr(), R, NB, SB, n,
            float(seg.near), float(seg.far), *K.launch_args(dev))
        K.raise_on_error(code, "fnt_block_hit")
        K.LAUNCHES["block_hit"] += 1
        return flags
