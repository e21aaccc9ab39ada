"""Weight packing of the Hopper kernels K1, K2, K3 and K4 (csrc/wg_trunk.cuh,
csrc/wg_field.cuh).

The kernels read every layer's kernel from shared memory as the B operand
of `wgmma`, in the no-swizzle K-major core-matrix layout: a layer's
(K, N) kernel is cut into slices of at most SLICE_K rows of K, and a slice
of kk rows is stored as (n, k) with element (k, n) at

    (n // 8)·kk·8 + (k // 8)·64 + (n % 8)·8 + k % 8        (bf16 elements)

so one bulk copy brings a whole slice into shared memory in the layout
`wgmma` reads. `march_slices` lists the slices in the order the kernels
consume them: for each trunk layer its h-kernel (SLICE_K-row slices) and
then its posenc-operand kernel (one slice of k0 rows; for a field packed
with hoist_x=False the x rows are inside it); with a view branch, then
the feature layer and the view layer. `field_slices_t` lists what K4's
dgrad products take after them: the transposes Wᵀ of the view and
feature layers, then of each trunk layer from the last down (the posenc
kernel's before the h-kernel's), cut the same way. The heads (σ, rgb,
out) stay in the flat buffer `PackedNet.w`: the kernels apply them as dot
products in their epilogues.

Each buffer is one gather (`index_select`) from `PackedNet.w` through a
permutation index built once per layout and device (`gather_index`), so a
training step, which packs its nets anew on every call, adds one launch a
buffer. `march_buffer` and `field_buffer` keep the result on the net;
`pack_slices` is the per-slice reference of the same buffer and
`unpack_slices` its plain inverse.
"""

from __future__ import annotations

import torch

SLICE_K = 64

_INDEX: dict = {}


def _slices(flat, net, transposed: bool) -> list:
    """[(kk, N) kernel views] of the flat buffer laid out as net.lay: the
    forward slices, or with transposed=True the dgrad slices alone."""
    lay, W, k0 = net.lay, net.width, net.k0

    def view(off, rows, cols):
        return flat[off:off + rows * cols].view(rows, cols)

    def cut(k):
        return [k[j:j + SLICE_K] for j in range(0, k.shape[0], SLICE_K)]

    out = []
    if not transposed:
        for i in range(net.depth):
            if lay["w_h"][i] is not None:
                out += cut(view(lay["w_h"][i], W, W))
            if lay["w_a0"][i] is not None:
                out.append(view(lay["w_a0"][i], k0, W))
        if net.has_vd:
            out += cut(view(lay["w_feat"], W, W))
            out += cut(view(lay["w_view"], W, W // 2))
        return out
    if net.has_vd:
        out += cut(view(lay["w_view"], W, W // 2).t())
        out += cut(view(lay["w_feat"], W, W).t())
    for i in reversed(range(net.depth)):
        if lay["w_a0"][i] is not None:
            out += cut(view(lay["w_a0"][i], k0, W).t())
        if lay["w_h"][i] is not None:
            out += cut(view(lay["w_h"][i], W, W).t())
    return out


def march_slices(net) -> list:
    """[(K, N) bf16 kernel views] of a packed net, in consumption order."""
    return _slices(net.w, net, False)


def field_slices_t(net) -> list:
    """The transposed slices K4's dgrad products stream after the
    forward's, each (kk, N) with kk ≤ SLICE_K rows of the layer's output."""
    return _slices(net.w, net, True)


def _tile(k):
    """(kk, N) → flat core-matrix order (see the module docstring)."""
    kk, N = k.shape
    return k.reshape(kk // 8, 8, N // 8, 8).permute(2, 0, 3, 1).reshape(-1)


def _untile(flat, kk: int, N: int):
    return flat.reshape(N // 8, kk // 8, 8, 8).permute(1, 3, 0, 2).reshape(
        kk, N)


def pack_slices(net, transposed: bool = False) -> torch.Tensor:
    """The reference packing: the net's forward slices (and with
    transposed=True the dgrad slices after them), each tiled, concatenated
    into one flat bf16 buffer."""
    ks = march_slices(net) + (field_slices_t(net) if transposed else [])
    return torch.cat([_tile(k) for k in ks]).contiguous()


def gather_index(net, transposed: bool, device) -> torch.Tensor:
    """Positions in net.w of `pack_slices(net, transposed)`'s elements:
    the same slicing and tiling applied to an arange, once per layout
    (depth, width, k0, skip layers, view branch) and device."""
    key = (net.depth, net.width, net.k0, net.skips, net.has_vd, transposed,
           str(device))
    if key not in _INDEX:
        src = torch.arange(net.lay["n_w"], dtype=torch.int64)
        ks = _slices(src, net, False) + (_slices(src, net, True)
                                         if transposed else [])
        _INDEX[key] = torch.cat([_tile(k) for k in ks]).to(device)
    return _INDEX[key]


def gather(net, transposed: bool = False) -> torch.Tensor:
    """`pack_slices(net, transposed)` by one gather from net.w."""
    return net.w.index_select(0, gather_index(net, transposed, net.w.device))


def march_buffer(net) -> torch.Tensor:
    """The march slices of K1/K2, gathered on first use and kept on the
    net."""
    if net.wg is None:
        net.wg = gather(net)
    return net.wg


def field_buffer(net, transposed: bool = False) -> torch.Tensor:
    """K3's slices (transposed=False, kept as net.wg) or K4's, the forward
    slices and then the dgrad slices (kept as net.wgt); gathered on first
    use."""
    if not transposed:
        return march_buffer(net)
    if net.wgt is None:
        net.wgt = gather(net, True)
    return net.wgt


def unpack_slices(buf, shapes) -> list:
    """Inverse of `pack_slices`: the flat buffer and the slices' (kk, N)
    shapes → [(kk, N) kernels]."""
    out, off = [], 0
    for kk, N in shapes:
        out.append(_untile(buf[off:off + kk * N], kk, N))
        off += kk * N
    return out
