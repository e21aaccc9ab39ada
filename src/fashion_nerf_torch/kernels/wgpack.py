"""Weight packing of the Hopper marches K1 and K2 (csrc/wg_trunk.cuh).

The marches read every layer's kernel from shared memory as the B operand
of `wgmma`, in the no-swizzle K-major core-matrix layout: a layer's
(K, N) kernel is cut into slices of at most SLICE_K rows of K, and a slice
of kk rows is stored as (n, k) with element (k, n) at

    (n // 8)·kk·8 + (k // 8)·64 + (n % 8)·8 + k % 8        (bf16 elements)

so one bulk copy brings a whole slice into shared memory in the layout
`wgmma` reads. `march_slices` lists the slices in the order the kernels
consume them (csrc/sigmamarch.cu, csrc/slimmarch.cu): for each trunk
layer its h-kernel (SLICE_K-row slices) and then its posenc-operand
kernel (one slice of k0 rows); with a view branch, then the feature
layer and the view layer. The heads (σ, rgb, out) stay in the flat
buffer `PackedNet.w`: the kernels apply them as dot products in their
epilogues. `march_buffer` builds the buffer once per net, at the first
kernel launch for a net packed by `split_hoist` or `pack_sigma`;
`unpack_slices` is the plain inverse of `pack_slices`.
"""

from __future__ import annotations

import torch

SLICE_K = 64


def march_slices(net) -> list:
    """[(K, N) bf16 kernel views] of a packed net, in consumption order."""
    lay, W = net.lay, net.width

    def view(off, rows, cols):
        return net.w[off:off + rows * cols].view(rows, cols)

    def cut(k):
        return [k[j:j + SLICE_K] for j in range(0, k.shape[0], SLICE_K)]

    out = []
    for i in range(net.depth):
        if lay["w_h"][i] is not None:
            out += cut(view(lay["w_h"][i], W, W))
        if lay["w_a0"][i] is not None:
            out.append(view(lay["w_a0"][i], net.k0, W))
    if net.has_vd:
        out += cut(view(lay["w_feat"], W, W))
        out += cut(view(lay["w_view"], W, W // 2))
    return out


def _tile(k):
    """(kk, N) → flat core-matrix order (see the module docstring)."""
    kk, N = k.shape
    return k.reshape(kk // 8, 8, N // 8, 8).permute(2, 0, 3, 1).reshape(-1)


def _untile(flat, kk: int, N: int):
    return flat.reshape(N // 8, kk // 8, 8, 8).permute(1, 3, 0, 2).reshape(
        kk, N)


def pack_slices(net) -> torch.Tensor:
    """The net's march slices packed for wgmma, one flat bf16 buffer."""
    return torch.cat([_tile(k) for k in march_slices(net)]).contiguous()


def march_buffer(net) -> torch.Tensor:
    """`pack_slices(net)`, built on first use and kept on the net."""
    if net.wg is None:
        net.wg = pack_slices(net)
    return net.wg


def unpack_slices(buf, shapes) -> list:
    """Inverse of `pack_slices`: the flat buffer and the slices' (kk, N)
    shapes → [(kk, N) kernels]."""
    out, off = [], 0
    for kk, N in shapes:
        out.append(_untile(buf[off:off + kk * N], kk, N))
        off += kk * N
    return out
