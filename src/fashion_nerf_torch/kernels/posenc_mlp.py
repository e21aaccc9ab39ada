"""Fused posenc + NeRF-MLP field (kernel K3, csrc/field.cu) and the packing
and row math the marches share.

Counterpart of `fashion_nerf.kernels.posenc_mlp_pallas` (`pack_params`,
`mlp_rows`, `_field_kernel`, `make_fused_field`).

Packing. A NeRFMLP is packed once into a flat bf16 weight buffer and a
flat f32 bias buffer in the order `_layout` gives (the same arithmetic as
`fnt::make_layout` in csrc/fnt_common.cuh). The trained posenc rows of the
first and skip layers are split as the reference's `_split_posenc_kernel`
does: the x rows, then the sin rows of every band, then the cos rows, so
that one sin pass over phases [x·2^f | x·2^f + π/2] covers both halves.
The layers' posenc operand ("a0") is [x | sin | cos] for the field and
[sin | cos] for the marches, whose x-paths are linear in t and hoisted
per ray; its width is padded with zero rows to a multiple of 16.

Numerics (kernel and plain version alike): bf16 operands rounded to
nearest even, f32 accumulation, activations rounded back to bf16 after the
relu, posenc phases in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.posenc import posenc
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP

_BF = torch.bfloat16


def _bf(x):
    """Round to bf16 (nearest even), keeping x's dtype."""
    return x.to(_BF).to(x.dtype)


def _freq_row(L: int, d: int = 3) -> np.ndarray:
    """(1, 2·d·L) band multipliers of the block-repeated layout: block b
    (d lanes) carries 2^(b mod L)."""
    row = np.zeros((1, 2 * d * L), np.float32)
    for b in range(2 * L):
        row[:, d * b:d * (b + 1)] = 2.0 ** (b % L)
    return row


def _phase_offset(L: int, d: int = 3) -> np.ndarray:
    """(1, 2·d·L): 0 on the sin half, π/2 on the cos half."""
    off = np.zeros((1, 2 * d * L), np.float32)
    off[:, d * L:] = np.pi / 2.0
    return off


def phase_consts(L: int, device):
    return (torch.from_numpy(_freq_row(L)).to(device),
            torch.from_numpy(_phase_offset(L)).to(device))


def _split_posenc_kernel(k, L: int, d: int = 3):
    """Rows of a ((1+2L)d, n) kernel → (Wx (d,n), Wsc (2dL,n)), Wsc stacked
    [sin rows; cos rows] to match the duplicated phase layout."""
    Wx = k[:d]
    Ws = torch.cat([k[d + 2 * d * i: 2 * d + 2 * d * i] for i in range(L)])
    Wc = torch.cat([k[2 * d + 2 * d * i: 3 * d + 2 * d * i]
                    for i in range(L)])
    return Wx, torch.cat([Ws, Wc])


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _layout(depth: int, width: int, k0: int, skip: int, has_vd: bool):
    """Element offsets into the flat buffers; see fnt::make_layout."""
    wo = bo = 0
    w_h, w_a0, b = [], [], []
    for i in range(depth):
        h = a = None
        if i == 0:
            a = wo
            wo += k0 * width
        elif i == skip:
            h = wo
            wo += width * width
            a = wo
            wo += k0 * width
        else:
            h = wo
            wo += width * width
        w_h.append(h)
        w_a0.append(a)
        b.append(bo)
        bo += width
    lay = {"w_h": w_h, "w_a0": w_a0, "b": b}
    if has_vd:
        half = width // 2
        for name, n_w, n_b in (("sig", width, 1), ("feat", width * width,
                                                    width),
                               ("view", width * half, half),
                               ("rgb", half * 3, 3)):
            lay["w_" + name], lay["b_" + name] = wo, bo
            wo += n_w
            bo += n_b
    else:
        lay["w_out"], lay["b_out"] = wo, bo
        wo += width * 4
        bo += 4
    lay["n_w"], lay["n_b"] = wo, bo
    return lay


@dataclass
class PackedNet:
    """A NeRFMLP packed for the slab kernels and their plain versions."""
    w: torch.Tensor            # flat bf16 weights
    wf: torch.Tensor           # the same values in f32 (plain versions)
    b: torch.Tensor            # flat f32 biases
    depth: int
    width: int
    k0: int                    # padded width of the posenc operand
    skip: int                  # index of the layer that takes the skip, -1
    has_vd: bool
    L: int                     # posenc frequencies of positions
    L_dir: int
    x_rows: bool               # posenc operand starts with x (field only)
    lay: dict
    dir_kernel: Optional[torch.Tensor]   # (Cd, W/2) f32 view-branch rows
    x_kernels: tuple           # ((Wx (3,W), b (W,)), ...) hoisted x-layers

    def wview(self, off: int, rows: int, cols: int):
        return self.wf[off:off + rows * cols].view(rows, cols)


def pack_params(model: NeRFMLP, hoist_x: bool) -> PackedNet:
    """Pack `model` for the field (hoist_x=False: the x rows stay in the
    posenc operand) or for the marches (hoist_x=True: the first and skip
    layers' x rows and biases leave the kernel as `x_kernels`; their bias
    slots in the buffer are zero)."""
    L, W, D = model.posenc_xyz, model.width, model.depth
    cx = 3 * (2 * L + 1)
    skips = [s + 1 for s in model.skips if s + 1 < D]
    if len(skips) > 1:
        raise NotImplementedError("more than one skip layer")
    skip = skips[0] if skips else -1
    k0 = _round16(6 * L if hoist_x else 3 + 6 * L)
    ws, bs, x_kernels = [], [], []

    def a0_rows(kern):
        Wx, Wsc = _split_posenc_kernel(kern, L)
        rows = Wsc if hoist_x else torch.cat([Wx, Wsc])
        return F.pad(rows, (0, 0, 0, k0 - rows.shape[0])), Wx

    with torch.no_grad():
        for i, layer in enumerate(model.trunk):
            kern, bias = layer.weight.t(), layer.bias
            if i == 0 or i == skip:
                if i == skip:
                    ws.append(kern[cx:])
                rows, Wx = a0_rows(kern[:cx])
                ws.append(rows)
                if hoist_x:
                    # the reference hoists the bf16-packed x rows, in f32
                    x_kernels.append((_bf(Wx), bias.float().clone()))
                    bias = torch.zeros_like(bias)
            else:
                ws.append(kern)
            bs.append(bias)
        dir_kernel = None
        if model.use_viewdirs:
            kv = model.view_0.weight.t()
            dir_kernel = kv[W:].float().clone()
            ws += [model.sigma_head.weight.t(), model.feature.weight.t(),
                   kv[:W], model.rgb_head.weight.t()]
            bs += [model.sigma_head.bias, model.feature.bias,
                   model.view_0.bias, model.rgb_head.bias]
        else:
            ws.append(model.out_head.weight.t())
            bs.append(model.out_head.bias)
        w = torch.cat([x.reshape(-1) for x in ws]).to(_BF).contiguous()
        b = torch.cat([x.reshape(-1) for x in bs]).float().contiguous()
    lay = _layout(D, W, k0, skip, model.use_viewdirs)
    assert (w.numel(), b.numel()) == (lay["n_w"], lay["n_b"])
    return PackedNet(w=w, wf=w.float(), b=b, depth=D, width=W, k0=k0,
                     skip=skip, has_vd=model.use_viewdirs, L=L,
                     L_dir=model.posenc_dir, x_rows=not hoist_x, lay=lay,
                     dir_kernel=dir_kernel, x_kernels=tuple(x_kernels))


def hoist_dirs(net: PackedNet, viewdirs):
    """Per-ray view-branch term γ(d̂)·W_dir → (R, W/2) bf16 (one small f32
    matmul per chunk, expanded per sample inside the kernels)."""
    R = viewdirs.shape[0]
    if not net.has_vd:
        return torch.zeros((R, max(net.width // 2, 1)), dtype=_BF,
                           device=viewdirs.device)
    d_unit = viewdirs / torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
    return (posenc(d_unit, net.L_dir) @ net.dir_kernel).to(_BF)


# --------------------------------------------------------------------------
# plain PyTorch row math (the kernels' numerics)
# --------------------------------------------------------------------------

def mlp_rows(net: PackedNet, a0, xterm=None, dir_rows=None):
    """The packed MLP on rows. a0 (rows, k0) bf16-valued f32 posenc operand;
    xterm(l) → (rows, W) f32 hoisted term of the l-th x-layer (marches);
    dir_rows (rows, W/2) f32 per-row view term. → (rgb (rows,3) post-sigmoid,
    σ (rows,) raw)."""
    lay, W, b = net.lay, net.width, net.b
    h, xi = None, 0
    for i in range(net.depth):
        acc = None
        if lay["w_h"][i] is not None:
            acc = h @ net.wview(lay["w_h"][i], W, W)
        if lay["w_a0"][i] is not None:
            p = a0 @ net.wview(lay["w_a0"][i], net.k0, W)
            acc = p if acc is None else acc + p
        acc = acc + b[lay["b"][i]:lay["b"][i] + W]
        if lay["w_a0"][i] is not None:
            if xterm is not None:
                acc = acc + xterm(xi)
            xi += 1
        h = _bf(torch.relu(acc))
    if net.has_vd:
        half = W // 2
        sigma = (h @ net.wview(lay["w_sig"], W, 1))[:, 0] + b[lay["b_sig"]]
        feat = _bf(h @ net.wview(lay["w_feat"], W, W)
                   + b[lay["b_feat"]:lay["b_feat"] + W])
        h2 = feat @ net.wview(lay["w_view"], W, half) + dir_rows
        h2 = _bf(torch.relu(h2 + b[lay["b_view"]:lay["b_view"] + half]))
        rgb = torch.sigmoid(h2 @ net.wview(lay["w_rgb"], half, 3)
                            + b[lay["b_rgb"]:lay["b_rgb"] + 3])
    else:
        raw = h @ net.wview(lay["w_out"], W, 4) \
            + b[lay["b_out"]:lay["b_out"] + 4]
        rgb, sigma = torch.sigmoid(raw[:, :3]), raw[:, 3]
    return rgb, sigma


def field_operand(x, L: int, k0: int):
    """Field posenc operand [bf16(x) | bf16(sin(P))] of positions x (n, 3)."""
    fmat, off = phase_consts(L, x.device)
    P = x.repeat(1, 2 * L) * fmat + off
    a0 = _bf(torch.cat([x, torch.sin(P)], dim=1))
    return F.pad(a0, (0, k0 - a0.shape[1]))


def field_rows_plain(net: PackedNet, pts, dirpart, spr: int):
    """Plain version of K3: pts (n,3) f32, dirpart (n/spr, W/2) bf16."""
    a0 = field_operand(pts, net.L, net.k0)
    dir_rows = (dirpart.float().repeat_interleave(spr, dim=0)
                if net.has_vd else None)
    rgb, sigma = mlp_rows(net, a0, dir_rows=dir_rows)
    return rgb, sigma


def field_rows(net: PackedNet, pts, dirpart, spr: int):
    """Fused field on rows → (rgb (n,3), σ (n,)). n must be a multiple of
    64 and of spr. CPU tensors: plain version; CUDA tensors: kernel K3."""
    n = pts.shape[0]
    if not K.on_cuda(pts, dirpart, net.w):
        return field_rows_plain(net, pts, dirpart, spr)
    if not net.x_rows:
        raise ValueError("field_rows needs a net packed with hoist_x=False")
    if n % K.SLAB_ROWS or n % spr:
        raise ValueError(f"rows {n} not a multiple of {K.SLAB_ROWS} and "
                         f"of spr={spr}")
    K.check(pts, "pts", torch.float32, (n, 3))
    K.check(dirpart, "dirpart", _BF, (n // spr, dirpart.shape[1]))
    if net.has_vd and dirpart.shape[1] != net.width // 2:
        raise ValueError(f"dirpart width {dirpart.shape[1]}")
    rgb = torch.empty((n, 3), dtype=torch.float32, device=pts.device)
    sigma = torch.empty((n,), dtype=torch.float32, device=pts.device)
    ptrs = [x.data_ptr() for x in (pts, dirpart, net.w, net.b, rgb, sigma)]
    code = K.library().fnt_field_forward(
        *ptrs, n, spr, net.L, net.depth, net.width, net.k0, net.skip,
        int(net.has_vd), K.stream())
    K.raise_on_error(code, "fnt_field_forward")
    K.LAUNCHES["field"] += 1
    return rgb, sigma


def make_fused_field(cfg, plain: bool = False):
    """Field fn with the reference convention:
    field(params, pts (R,S,3), viewdirs (R,3), cond=None) → (rgb (R,S,3),
    σ (R,S)), where params is a NeRFMLP. Runs K3 on CUDA tensors (the
    plain version on CPU tensors, or everywhere with plain=True)."""
    del cfg   # the architecture is read off the module

    def field(params: NeRFMLP, pts, viewdirs, cond=None):
        if cond is not None:
            raise NotImplementedError(
                "conditioned fields are not ported (ROADMAP Queue 1 #11)")
        net = pack_params(params, hoist_x=False)
        R, S = pts.shape[0], pts.shape[1]
        step = K.SLAB_ROWS // math.gcd(S, K.SLAB_ROWS)
        R_pad = -(-R // step) * step
        flat = F.pad(pts.reshape(R, S, 3), (0, 0, 0, 0, 0, R_pad - R))
        dirpart = F.pad(hoist_dirs(net, viewdirs), (0, 0, 0, R_pad - R))
        fn = field_rows_plain if plain else field_rows
        rgb, sigma = fn(net, flat.reshape(-1, 3).contiguous(),
                        dirpart.contiguous(), S)
        return (rgb[:R * S].reshape(R, S, 3), sigma[:R * S].reshape(R, S))

    return field
