"""Fused posenc + NeRF-MLP field (kernel K3, csrc/field.cu) and the packing
and row math the marches share.

Counterpart of `fashion_nerf.kernels.posenc_mlp_pallas` (`pack_params`,
`mlp_rows`, `_field_kernel`, `make_fused_field`).

Packing. A NeRFMLP is packed once into a flat bf16 weight buffer and a
flat f32 bias buffer in the order `_layout` gives (the same arithmetic as
`fnt::make_layout` in csrc/fnt_common.cuh). A net may have any number of
skip layers, as the reference's plan has a skip entry for each. The
trained posenc rows of the first layer and of every skip layer are split
as the reference's `_split_posenc_kernel` does: the x rows, then the sin
rows of every band, then the cos rows, so that one sin pass over phases
[x·2^f | x·2^f + π/2] covers both halves.
The layers' posenc operand ("a0") is [x | sin | cos] for the field and
[sin | cos] for the marches, whose x-paths are linear in t and hoisted
per ray; its width is padded with zero rows to a multiple of 16.

Conditioning. A conditioned net's trunk_0 and skip layers carry Cc rows
that act on the per-ray cond vector; `pack_params` lifts them into
`cond_kernel` (Cc, n_cond·W), as the reference's `pack_params` does, and
`hoist_cond` computes the per-ray condpart bf16(cond @ cond_kernel) once
per chunk. K3 and K6 add float(condpart) slice i to the accumulator of
the i-th conditioned layer before its bias; K2 takes it folded into its
hoisted x-intercepts (slimmarch.hoist_rays). A conditioned net's marches
predicate per half tile (`tile_rows`), as the reference's conditioned plans
do. Under grad the hoist stays plain torch: K4 returns the condpart's
cotangent (the f32 pre-activation cotangents of those layers, summed per
ray), and autograd carries it through cond @ cond_kernel to the cond and
to the cond rows, as the reference's XLA `cond_vjp` does.

Shapes. K3, K4 and K6 take widths 128 and 256, depths 2-8 and a posenc
operand of 48 or 64 columns (`check_field_shape`). The wrappers run any
narrower net zero-padded to the nearest such shape (`pad_packed`,
`kernel_net`) and cut K4's gradients back to the unpadded layout, so the
reference's small nets (width 16-64, L = 2-4) run through the kernels.

Numerics (kernel and plain version alike): bf16 operands rounded to
nearest even, f32 accumulation, activations rounded back to bf16 after the
relu, posenc phases in f32.

Gradients (kernel K4, csrc/field_bwd.cu, and `field_rows_backward_plain`)
follow `_field_bwd_kernel`: the forward is recomputed; the cotangents of
every pre-activation are rounded to bf16 as the operands of both the dgrad
and the wgrad products, which accumulate in f32; bias gradients are f32
sums of the unrounded cotangents (of the rounded ones where the reference
rounds first: the rgb head and the feature layer); sin/cos stay f32.
`FusedField` puts K3 and K4 under autograd. With grad enabled,
`pack_params` packs differentiably into an f32 flat buffer, so autograd of
the packing (cat, transpose, pad) carries the flat gradients back onto the
NeRFMLP parameters; the bf16 casts of the weights and of the per-ray view
and cond terms happen inside `FusedField`, so their gradients stay f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.config import takes_fused_field
from fashion_nerf_torch.kernels import wgpack
from fashion_nerf_torch.core.posenc import posenc
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP, module_field
from fashion_nerf_torch.trace import span

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


def _layout(depth: int, width: int, k0: int, skips, has_vd: bool):
    """Element offsets into the flat buffers; see fnt::make_layout. skips:
    the layers after the first that take the posenc operand (γ(x)), each
    packed as its h-kernel and then its posenc kernel."""
    wo = bo = 0
    w_h, w_a0, b = [], [], []
    for i in range(depth):
        h = a = None
        if i == 0:
            a = wo
            wo += k0 * width
        elif i in skips:
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
    """A NeRFMLP packed for the kernels and their plain versions."""
    w: torch.Tensor            # flat bf16 weights (never carries grad)
    wf: torch.Tensor           # the same values in f32 (plain versions)
    b: torch.Tensor            # flat f32 biases (carries grad when packed so)
    depth: int
    width: int
    k0: int                    # padded width of the posenc operand
    skips: tuple               # layers after the first that take γ(x)
    has_vd: bool
    L: int                     # posenc frequencies of positions
    L_dir: int
    x_rows: bool               # posenc operand starts with x (field only)
    lay: dict
    dir_kernel: Optional[torch.Tensor]   # (Cd, W/2) f32 view-branch rows
    x_kernels: tuple           # ((Wx (3,W), b (W,)), ...) hoisted x-layers
    w32: Optional[torch.Tensor] = None   # unrounded f32 weights with grad
    wg: Optional[torch.Tensor] = None    # wgmma slices (wgpack), K1/K2/K3
    wgt: Optional[torch.Tensor] = None   # and their transposes after them, K4
    padded: Optional["PackedNet"] = None  # this net padded for K3/K4/K6
    unpad: Optional[tuple] = None        # of a padded net: (pos_w, pos_b),
    #                                      where the unpadded entries lie
    cond_kernel: Optional[torch.Tensor] = None   # (Cc, n_cond·W) f32

    @property
    def skip_mask(self) -> int:
        """The kernels' layout argument: bit i set for each skip layer i."""
        return sum(1 << i for i in self.skips)

    def wview(self, off: int, rows: int, cols: int):
        return self.wf[off:off + rows * cols].view(rows, cols)

    @property
    def n_cond(self) -> int:
        """Layers that take the cond input (trunk_0 and every skip layer of
        a conditioned net, else none)."""
        return 0 if self.cond_kernel is None else \
            self.cond_kernel.shape[1] // self.width

    @property
    def tile_rows(self) -> int:
        """Rows of a march's predication tile: halved for a conditioned
        net, as the reference's conditioned plans halve theirs."""
        return K.TILE_ROWS // 2 if self.n_cond else K.TILE_ROWS


def pack_params(model: NeRFMLP, hoist_x: bool) -> PackedNet:
    """Pack `model` for the field (hoist_x=False: the x rows stay in the
    posenc operand) or for the marches (hoist_x=True: the x rows and biases
    of the first layer and of every skip layer leave the kernel as
    `x_kernels`, one pair a layer in order; their bias slots in the buffer
    are zero). A conditioned net's cond rows of those layers become
    `cond_kernel`, a W-wide block a layer in the same order. A field
    packed with grad enabled keeps the autograd graph: `w32` (the f32 flat
    weights), `b`, `dir_kernel` and `cond_kernel` lead back to the model's
    parameters (see FusedField); the kernels read detached copies."""
    L, W, D = model.posenc_xyz, model.width, model.depth
    cx = 3 * (2 * L + 1)
    Cc = model.cond_dim
    skips = tuple(sorted({s + 1 for s in model.skips if s + 1 < D}))
    k0 = _round16(6 * L if hoist_x else 3 + 6 * L)
    ws, bs, x_kernels, cond_blocks = [], [], [], []

    def a0_rows(kern):
        Wx, Wsc = _split_posenc_kernel(kern, L)
        rows = Wsc if hoist_x else torch.cat([Wx, Wsc])
        return F.pad(rows, (0, 0, 0, k0 - rows.shape[0])), Wx

    grad = torch.is_grad_enabled() and not hoist_x
    with torch.set_grad_enabled(grad):
        for i, layer in enumerate(model.trunk):
            kern, bias = layer.weight.t(), layer.bias
            if i == 0 or i in skips:
                if i in skips:
                    ws.append(kern[cx + Cc:])
                if Cc:
                    cond_blocks.append(kern[cx:cx + Cc].float())
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
        w32 = torch.cat([x.reshape(-1) for x in ws]).float().contiguous()
        b = torch.cat([x.reshape(-1) for x in bs]).float().contiguous()
    w = w32.detach().to(_BF).contiguous()
    lay = _layout(D, W, k0, skips, model.use_viewdirs)
    assert (w.numel(), b.numel()) == (lay["n_w"], lay["n_b"])
    return PackedNet(w=w, wf=w.float(), b=b, depth=D, width=W, k0=k0,
                     skips=skips, has_vd=model.use_viewdirs, L=L,
                     L_dir=model.posenc_dir, x_rows=not hoist_x, lay=lay,
                     dir_kernel=dir_kernel, x_kernels=tuple(x_kernels),
                     w32=w32 if grad else None,
                     cond_kernel=(torch.cat(cond_blocks, dim=1).contiguous()
                                  if cond_blocks else None))


def dir_term(net: PackedNet, viewdirs):
    """Per-ray view-branch term γ(d̂)·W_dir → (R, W/2) f32 (zeros without a
    view branch). Plain torch, so autograd backprops it as the reference's
    XLA vjp backprops its hoist."""
    R = viewdirs.shape[0]
    if not net.has_vd:
        return torch.zeros((R, max(net.width // 2, 1)),
                           device=viewdirs.device)
    d_unit = viewdirs / torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
    return posenc(d_unit, net.L_dir) @ net.dir_kernel


def hoist_dirs(net: PackedNet, viewdirs):
    """`dir_term` rounded to bf16, as the kernels take it (one small f32
    matmul per chunk, expanded per sample inside the kernels)."""
    return dir_term(net, viewdirs).to(_BF)


def cond_term(net: PackedNet, cond):
    """The per-ray condpart cond @ cond_kernel (R, n_cond·W) f32. Plain
    torch, so autograd carries its gradient to the cond and the cond rows
    (the reference's `cond_vjp`)."""
    if net.cond_kernel is None:
        raise ValueError("a cond was given but the net has no cond rows")
    return cond.float() @ net.cond_kernel


def hoist_cond(net: PackedNet, cond):
    """`cond_term` rounded to bf16, as the kernels take it; None without a
    cond."""
    if cond is None:
        return None
    return cond_term(net, cond).to(_BF).contiguous()


# --------------------------------------------------------------------------
# plain PyTorch row math (the kernels' numerics)
# --------------------------------------------------------------------------

def mlp_rows(net: PackedNet, a0, xterm=None, dir_rows=None, cond_rows=None):
    """The packed MLP on rows. a0 (rows, k0) bf16-valued f32 posenc operand;
    xterm(l) → (rows, W) f32 hoisted term of the l-th x-layer (marches);
    dir_rows (rows, W/2) f32 per-row view term; cond_rows (rows, n_cond·W)
    f32 per-row condpart, slice l added to the l-th x-layer before its bias.
    → (rgb (rows,3) post-sigmoid, σ (rows,) raw)."""
    lay, W, b = net.lay, net.width, net.b
    h, xi = None, 0
    for i in range(net.depth):
        acc = None
        if lay["w_h"][i] is not None:
            acc = h @ net.wview(lay["w_h"][i], W, W)
        if lay["w_a0"][i] is not None:
            p = a0 @ net.wview(lay["w_a0"][i], net.k0, W)
            acc = p if acc is None else acc + p
            if cond_rows is not None:
                acc = acc + cond_rows[:, xi * W:(xi + 1) * W]
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


def per_row(part, spr: int):
    """A per-ray bf16 operand (R, C) expanded to f32 rows (R·spr, C)."""
    return None if part is None else part.float().repeat_interleave(spr, 0)


DEAD_SIGMA = -1e10   # σ of a dead tile's rows: post-relu density 0, α = 0


def alive_tile_rows(net: PackedNet, n: int) -> int:
    """Rows of one tile-skip flag over n rows: the net's predication tile
    (2048, 1024 for a conditioned net; the reference's tile_eff), or all n
    rows when fewer. Raises unless n is whole tiles."""
    tile = min(net.tile_rows, n)
    if tile <= 0 or n % tile:
        raise ValueError(f"rows {n} are not whole tiles of {tile}")
    return tile


def _field_rows_plain(net: PackedNet, pts, dirpart, spr: int, condpart):
    a0 = field_operand(pts, net.L, net.k0)
    dir_rows = per_row(dirpart, spr) if net.has_vd else None
    return mlp_rows(net, a0, dir_rows=dir_rows,
                    cond_rows=per_row(condpart, spr))


def field_rows_plain(net: PackedNet, pts, dirpart, spr: int, condpart=None,
                     alive=None):
    """Plain version of K3: pts (n,3) f32, dirpart (n/spr, W/2) bf16,
    condpart (n/spr, n_cond·W) bf16 or None; alive (n / tile,) f32 tile
    flags (`alive_tile_rows`) or None: the rows of a tile whose flag is not
    > 0 are rgb = 0, σ = DEAD_SIGMA, and only the live tiles' rows are
    computed."""
    if alive is None:
        return _field_rows_plain(net, pts, dirpart, spr, condpart)
    n = pts.shape[0]
    tile = alive_tile_rows(net, n)
    if tile % spr or tuple(alive.shape) != (n // tile,):
        raise ValueError(f"alive {tuple(alive.shape)}: one flag per "
                         f"{tile} rows of {n}, whole rays of {spr}")
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=pts.device)
    sigma = torch.full((n,), DEAD_SIGMA, dtype=torch.float32,
                       device=pts.device)
    rows = (alive > 0).repeat_interleave(tile).nonzero().squeeze(1)
    if rows.numel():
        rays = rows[::spr] // spr
        rgb[rows], sigma[rows] = _field_rows_plain(
            net, pts[rows], dirpart[rays], spr,
            None if condpart is None else condpart[rays])
    return rgb, sigma


def check_field_shape(n: int, spr: int, width: int, depth: int,
                      k0: int) -> None:
    """Raise unless K3/K4 take n rows of spr samples a ray and a net of
    this width, depth and posenc operand width (kernels.FIELD_WIDTHS,
    FIELD_DEPTHS, FIELD_K0: the 8×256 fields and the 2×128 proposal net,
    L = 10 or 6); n a multiple of 64 (half work items are fine) and of
    spr."""
    if width not in K.FIELD_WIDTHS:
        raise ValueError(f"net width {width}: the field kernels take widths "
                         f"{K.FIELD_WIDTHS}")
    if depth not in K.FIELD_DEPTHS:
        raise ValueError(f"net depth {depth}: the field kernels take depths "
                         f"{K.FIELD_DEPTHS[0]}-{K.FIELD_DEPTHS[-1]}")
    if k0 not in K.FIELD_K0:
        raise ValueError(f"posenc operand width {k0}: the field kernels take "
                         f"{K.FIELD_K0} (L = 10 or 6 with the x rows)")
    if spr < 1 or n < 0 or n % K.SLAB_ROWS or n % spr:
        raise ValueError(f"rows {n} not a multiple of {K.SLAB_ROWS} and "
                         f"of spr={spr} (spr ≥ 1)")


_PAD_POS: dict = {}


def pad_target(width: int, depth: int, k0: int) -> tuple:
    """(width, k0) of the nearest net the field kernels take that a net of
    this width, depth and posenc operand width pads into: the width up to
    128 or 256, k0 up to 48 or 64. Raises ValueError, naming why, for a net
    that no padding brings into the range: wider than 256, deeper than 8,
    a posenc operand over 64 columns (3 + 6L > 64), or a single trunk layer
    (depth 1 is not padded with a layer; it raises)."""
    if depth not in K.FIELD_DEPTHS:
        raise ValueError(f"net depth {depth}: the field kernels take depths "
                         f"{K.FIELD_DEPTHS[0]}-{K.FIELD_DEPTHS[-1]}, and "
                         "padding adds no layer")
    wide = [w for w in K.FIELD_WIDTHS if w >= width]
    if width < 1 or not wide:
        raise ValueError(f"net width {width}: the field kernels take widths "
                         f"{K.FIELD_WIDTHS}, narrower nets padded")
    ks = [k for k in K.FIELD_K0 if k >= k0]
    if not ks:
        raise ValueError(f"posenc operand width {k0}: the field kernels take "
                         f"at most {K.FIELD_K0[-1]} columns (3 + 6L ≤ 64)")
    return wide[0], ks[0]


def _pad_positions(net: PackedNet, Wp: int, k0p: int, device):
    """(pos_w, pos_b, layout): where each entry of the net's flat weight
    and bias buffers lies in the flat buffers of the same net at width Wp
    and posenc operand width k0p (every tensor keeps its rows and columns
    from 0; the view layer is Wp/2 wide). Built once per shape and device."""
    key = (net.depth, net.width, net.k0, net.skips, net.has_vd, Wp, k0p,
           str(device))
    if key not in _PAD_POS:
        W, k0, lay = net.width, net.k0, net.lay
        big = _layout(net.depth, Wp, k0p, net.skips, net.has_vd)
        pos_w = torch.empty(lay["n_w"], dtype=torch.int64)
        pos_b = torch.empty(lay["n_b"], dtype=torch.int64)

        def put(pos, off, off_p, rows, cols, cols_p):
            r = torch.arange(rows)[:, None]
            c = torch.arange(cols)[None, :]
            pos[off:off + rows * cols] = (off_p + r * cols_p + c).reshape(-1)

        for i in range(net.depth):
            if lay["w_h"][i] is not None:
                put(pos_w, lay["w_h"][i], big["w_h"][i], W, W, Wp)
            if lay["w_a0"][i] is not None:
                put(pos_w, lay["w_a0"][i], big["w_a0"][i], k0, W, Wp)
            put(pos_b, lay["b"][i], big["b"][i], 1, W, Wp)
        if net.has_vd:
            h, hp = W // 2, Wp // 2
            for name, rows, cols, cols_p, nb in (
                    ("sig", W, 1, 1, 1), ("feat", W, W, Wp, W),
                    ("view", W, h, hp, h), ("rgb", h, 3, 3, 3)):
                put(pos_w, lay["w_" + name], big["w_" + name], rows, cols,
                    cols_p)
                put(pos_b, lay["b_" + name], big["b_" + name], 1, nb, nb)
        else:
            put(pos_w, lay["w_out"], big["w_out"], W, 4, 4)
            put(pos_b, lay["b_out"], big["b_out"], 1, 4, 4)
        _PAD_POS[key] = (pos_w.to(device), pos_b.to(device), big)
    return _PAD_POS[key]


def pad_packed(net: PackedNet, width: Optional[int] = None) -> PackedNet:
    """`net` padded with zeros: a field-packed net (hoist_x=False) to the
    nearest shape K3, K4 and K6 take (`pad_target`), a march-packed net
    (hoist_x=True) to `width` with its posenc operand as it is (the σ
    march's wider proposals, which K2 runs at width 256). Zero weight rows
    and columns and zero biases in the `_layout` order, the view layer at
    half the padded width, `dir_kernel` and the hoisted x-layers with zero
    columns. A padded column is relu(0 + 0) = 0 (0 + 0 in the feature
    layer), bf16(0) = 0, and a padded row multiplies an exact zero, so the
    padded net computes the same function: every f32 sum gains only +0.0
    terms. The padded net's `unpad` holds where the original entries lie,
    for cutting gradients back. The kernels then spend the padded net's
    multiply-adds on every row; that is the price of one kernel for every
    width."""
    if net.x_rows:
        Wp, k0p = pad_target(net.width, net.depth, net.k0)
    elif width is None or width < net.width:
        raise ValueError("a net packed with hoist_x=True pads to a width "
                         "at least its own, given")
    else:
        Wp, k0p = width, net.k0
    pos_w, pos_b, lay = _pad_positions(net, Wp, k0p, net.w.device)
    w = torch.zeros(lay["n_w"], dtype=_BF, device=net.w.device)
    w[pos_w] = net.w
    b = torch.zeros(lay["n_b"], dtype=torch.float32, device=net.b.device)
    b[pos_b] = net.b.detach()
    dk = net.dir_kernel
    if dk is not None:
        dk = F.pad(dk.detach(), (0, Wp // 2 - dk.shape[1]))
    ck = net.cond_kernel
    if ck is not None:
        ck = pad_condpart(net, Wp, ck.detach())
    cols = (0, Wp - net.width)
    xk = tuple((F.pad(Wx, cols), F.pad(bx, cols)) for Wx, bx in net.x_kernels)
    return PackedNet(w=w, wf=w.float(), b=b, depth=net.depth, width=Wp,
                     k0=k0p, skips=net.skips, has_vd=net.has_vd, L=net.L,
                     L_dir=net.L_dir, x_rows=net.x_rows, lay=lay,
                     dir_kernel=dk, x_kernels=xk, unpad=(pos_w, pos_b),
                     cond_kernel=ck)


def kernel_net(net: PackedNet) -> PackedNet:
    """`net` itself when K3, K4 and K6 take its shape, else its padded
    version, built on first use and kept on the net (a net packed anew on
    every call, as a training step packs it, pads once per call). Raises
    ValueError for a net that cannot be padded into the range."""
    if (net.width in K.FIELD_WIDTHS and net.depth in K.FIELD_DEPTHS
            and net.k0 in K.FIELD_K0):
        return net
    if net.padded is None:
        net.padded = pad_packed(net)
    return net.padded


def pad_condpart(net: PackedNet, Wp: int, condpart):
    """(rows, n_cond·W) → (rows, n_cond·Wp): each W-wide slice widened with
    zero columns (a padded column's accumulator stays 0)."""
    if condpart is None or Wp == net.width:
        return condpart
    rows = condpart.shape[0]
    return F.pad(condpart.reshape(rows, -1, net.width),
                 (0, Wp - net.width)).reshape(rows, -1).contiguous()


def check_condpart(net: PackedNet, condpart, rays: int):
    """Raise unless condpart is a (rays, n_cond·W) bf16 condpart of net."""
    if (condpart is None) != (net.n_cond == 0):
        raise ValueError("a conditioned net takes a condpart, and only it")
    if condpart is not None:
        K.check(condpart, "condpart", _BF, (rays, net.n_cond * net.width))


def pad_dirpart(net: PackedNet, knet: PackedNet, dirpart):
    """The per-ray view term widened with zero columns to the padded net's
    view layer."""
    if knet is net or not net.has_vd:
        return dirpart
    if dirpart.shape[1] != net.width // 2:
        raise ValueError(f"dirpart width {dirpart.shape[1]}")
    return F.pad(dirpart, (0, knet.width // 2 - dirpart.shape[1]))


def field_rows(net: PackedNet, pts, dirpart, spr: int, condpart=None,
               alive=None):
    """Fused field on rows → (rgb (n,3), σ (n,)). n must be a multiple of
    64 and of spr; a conditioned net takes its per-ray condpart (n/spr,
    n_cond·W) bf16 (`hoist_cond`). alive: None, or the tile-skip flags of
    the two-stage march, (n / tile,) f32 on the device, one per tile of
    `alive_tile_rows(net, n)` rows: a tile whose flag is not > 0 does no
    matrix work and writes rgb = 0, σ = DEAD_SIGMA. The flags are never
    read on the host. CPU tensors: plain version; CUDA tensors: kernel K3.
    A net narrower than the kernel's widths, or with a narrower posenc
    operand, runs padded with zeros (`pad_packed`): the same function at
    the padded net's cost in tensor-core time."""
    n = pts.shape[0]
    dev = K.on_cuda(pts, dirpart, net.w, condpart, alive)
    if dev is None:
        return field_rows_plain(net, pts, dirpart, spr, condpart, alive)
    with span("fnt.kernel.field"):
        if not net.x_rows:
            raise ValueError("field_rows needs a net packed with "
                             "hoist_x=False")
        unpadded = net
        net = kernel_net(unpadded)
        check_field_shape(n, spr, net.width, net.depth, net.k0)
        K.check(pts, "pts", torch.float32, (n, 3))
        K.check(dirpart, "dirpart", _BF, (n // spr, dirpart.shape[1]))
        check_condpart(unpadded, condpart, n // spr)
        tile = 0
        if alive is not None:
            tile = alive_tile_rows(unpadded, n)
            K.check(alive, "alive", torch.float32, (n // tile,))
        dirpart = pad_dirpart(unpadded, net, dirpart)
        condpart = pad_condpart(unpadded, net.width, condpart)
        if net.has_vd and dirpart.shape[1] != net.width // 2:
            raise ValueError(f"dirpart width {dirpart.shape[1]}")
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        sigma = torch.empty((n,), dtype=torch.float32, device=dev)
        wp = wgpack.field_buffer(net)
        ptrs = [x.data_ptr() for x in (pts, dirpart, net.w, wp, net.b, rgb,
                                       sigma)]
        cw = 0 if condpart is None else condpart.shape[1]
        code = K.library().fnt_field_forward(
            *ptrs, condpart.data_ptr() if cw else None,
            None if alive is None else alive.data_ptr(), cw, tile, n, spr,
            net.L, net.depth, net.width, net.k0, net.skip_mask,
            int(net.has_vd), *K.launch_args(dev))
        K.raise_on_error(code, "fnt_field_forward")
        K.LAUNCHES["field_alive" if alive is not None else
                   "field_cond" if cw else "field"] += 1
        return rgb, sigma


def _rows_bwd_heads(net: PackedNet, h, dir_rows, g_rgb, g_sigma, gw, gb):
    """Backward of the heads on rows of trunk output h (bf16-valued f32).
    Writes the heads' weight/bias gradients into gw/gb; → (d_h (rows, W)
    f32, per-row view-term cotangent (rows, W/2) f32 or None)."""
    lay, W, b = net.lay, net.width, net.b

    def put(key, val):
        gw[lay[key]:lay[key] + val.numel()] = val.reshape(-1)

    if not net.has_vd:
        w_out = net.wview(lay["w_out"], W, 4)
        s = torch.sigmoid(h @ w_out[:, :3] + b[lay["b_out"]:lay["b_out"] + 3])
        d_raw = _bf(torch.cat([g_rgb * s * (1.0 - s), g_sigma[:, None]], 1))
        put("w_out", h.t() @ d_raw)
        gb[lay["b_out"]:lay["b_out"] + 4] = d_raw.sum(0)
        return d_raw @ w_out.t(), None
    half = W // 2
    w_feat = net.wview(lay["w_feat"], W, W)
    w_view = net.wview(lay["w_view"], W, half)
    w_rgb = net.wview(lay["w_rgb"], half, 3)
    feat = _bf(h @ w_feat + b[lay["b_feat"]:lay["b_feat"] + W])
    h2 = feat @ w_view + dir_rows
    h2 = _bf(torch.relu(h2 + b[lay["b_view"]:lay["b_view"] + half]))
    s = torch.sigmoid(h2 @ w_rgb + b[lay["b_rgb"]:lay["b_rgb"] + 3])
    d_raw = _bf(g_rgb * s * (1.0 - s))
    put("w_rgb", h2.t() @ d_raw)
    gb[lay["b_rgb"]:lay["b_rgb"] + 3] = d_raw.sum(0)
    d_h2pre = torch.where(h2 > 0, d_raw @ w_rgb.t(), 0.0)
    d_h2pre_bf = _bf(d_h2pre)
    put("w_view", feat.t() @ d_h2pre_bf)
    gb[lay["b_view"]:lay["b_view"] + half] = d_h2pre.sum(0)
    d_feat = _bf(d_h2pre_bf @ w_view.t())
    put("w_feat", h.t() @ d_feat)
    gb[lay["b_feat"]:lay["b_feat"] + W] = d_feat.sum(0)
    gs_bf = _bf(g_sigma)
    put("w_sig", h.t() @ gs_bf[:, None])
    gb[lay["b_sig"]] = g_sigma.sum()
    d_h = d_feat @ w_feat.t() + gs_bf[:, None] * net.wf[
        lay["w_sig"]:lay["w_sig"] + W][None, :]
    return d_h, d_h2pre


def field_rows_backward_plain(net: PackedNet, pts, dirpart, g_rgb, g_sigma,
                              spr: int, condpart=None):
    """Plain version of K4, the VJP of K3 with the reference's rounding
    points (explicit, not autograd): pts (n,3) f32, dirpart (n/spr, W/2)
    bf16, cotangents g_rgb (n,3) and g_sigma (n,) f32 → (d_pts (n,3),
    d_dirpart (n/spr, W/2) summed per ray, d_w (n_w,), d_b (n_b,)), all
    f32, d_w and d_b in the flat layout of net.w and net.b. A conditioned
    net takes its condpart (n/spr, n_cond·W) bf16, added to the cond
    layers' accumulators before the bias as the reference's recompute adds
    it, and a fifth output d_condpart (n/spr, n_cond·W) f32: each cond
    layer's unrounded pre-activation cotangent, summed per ray."""
    lay, W, L, k0 = net.lay, net.width, net.L, net.k0
    n = pts.shape[0]
    fmat, off = phase_consts(L, pts.device)
    P = pts.repeat(1, 2 * L) * fmat + off
    a0 = field_operand(pts, L, k0)
    dir_rows = (dirpart.float().repeat_interleave(spr, dim=0)
                if net.has_vd else None)
    cond_rows = per_row(condpart, spr)
    hs, h, ci = [], None, 0
    for i in range(net.depth):                     # forward recompute
        acc = 0.0
        if lay["w_h"][i] is not None:
            acc = h @ net.wview(lay["w_h"][i], W, W)
        if lay["w_a0"][i] is not None:
            acc = acc + a0 @ net.wview(lay["w_a0"][i], k0, W)
            if cond_rows is not None:
                acc = acc + cond_rows[:, ci * W:(ci + 1) * W]
            ci += 1
        h = _bf(torch.relu(acc + net.b[lay["b"][i]:lay["b"][i] + W]))
        hs.append(h)
    gw = torch.zeros(lay["n_w"], device=pts.device)
    gb = torch.zeros(lay["n_b"], device=pts.device)
    d_h, d_rows = _rows_bwd_heads(net, h, dir_rows, g_rgb.float(),
                                  g_sigma.float(), gw, gb)
    d_a0 = torch.zeros((n, k0), device=pts.device)
    d_cond = ([None] * ci) if cond_rows is not None else None
    for i in reversed(range(net.depth)):           # trunk backward
        d_pre = torch.where(hs[i] > 0, d_h, 0.0)
        d_pre_bf = _bf(d_pre)
        gb[lay["b"][i]:lay["b"][i] + W] = d_pre.sum(0)
        if lay["w_a0"][i] is not None:
            ci -= 1
            if d_cond is not None:
                d_cond[ci] = d_pre
            w_a0 = net.wview(lay["w_a0"][i], k0, W)
            gw[lay["w_a0"][i]:lay["w_a0"][i] + k0 * W] = (
                a0.t() @ d_pre_bf).reshape(-1)
            d_a0 = d_a0 + d_pre_bf @ w_a0.t()
        if lay["w_h"][i] is not None:
            w_h = net.wview(lay["w_h"][i], W, W)
            gw[lay["w_h"][i]:lay["w_h"][i] + W * W] = (
                hs[i - 1].t() @ d_pre_bf).reshape(-1)
            d_h = d_pre_bf @ w_h.t()
    # phases: d sin(P)/dP = cos(P), chained through P = x·2^(b mod L) + off
    dP = d_a0[:, 3:3 + 6 * L] * torch.cos(P) * fmat
    d_pts = dP.reshape(n, 2 * L, 3).sum(1) + d_a0[:, :3]
    R = n // spr
    if d_rows is None:
        d_dir = torch.zeros((R, dirpart.shape[1]), device=pts.device)
    else:
        d_dir = d_rows.reshape(R, spr, -1).sum(1)
    if d_cond is None:
        return d_pts, d_dir, gw, gb
    d_cp = torch.cat(d_cond, dim=1).reshape(R, spr, -1).sum(1)
    return d_pts, d_dir, gw, gb, d_cp


def bwd_workspace_cols(net: PackedNet) -> int:
    """bf16 columns per row of K4's workspace (fnt::Regions in
    csrc/field_bwd.cu): a0, every trunk activation and its cotangent, the
    feature layer, the view layer, and the two 16-wide head cotangents."""
    W = net.width
    return net.k0 + 2 * net.depth * W + 2 * W + 2 * (W // 2) + 32


def field_rows_backward(net: PackedNet, pts, dirpart, g_rgb, g_sigma,
                        spr: int, condpart=None):
    """VJP of `field_rows` → (d_pts (n,3), d_dirpart (n/spr, W/2), d_w,
    d_b), all f32, and with a conditioned net's condpart (n/spr, n_cond·W)
    bf16 a fifth output d_condpart (n/spr, n_cond·W) f32, as
    `field_rows_backward_plain`. CPU tensors: plain version; CUDA tensors:
    kernel K4, which is deterministic (fixed-order reductions, no float
    atomics). A net outside the kernel's widths runs padded (`pad_packed`),
    and d_w, d_b, d_dirpart and d_condpart come back in the unpadded net's
    layout."""
    n = pts.shape[0]
    dev = K.on_cuda(pts, dirpart, net.w, g_rgb, g_sigma, condpart)
    if dev is None:
        return field_rows_backward_plain(net, pts, dirpart, g_rgb, g_sigma,
                                         spr, condpart)
    with span("fnt.kernel.field_bwd"):
        if not net.x_rows:
            raise ValueError("field_rows_backward needs a net packed with "
                             "hoist_x=False")
        unpadded, cols = net, dirpart.shape[1]
        net = kernel_net(unpadded)
        check_field_shape(n, spr, net.width, net.depth, net.k0)
        K.check(pts, "pts", torch.float32, (n, 3))
        K.check(dirpart, "dirpart", _BF, (n // spr, cols))
        K.check(g_rgb, "g_rgb", torch.float32, (n, 3))
        K.check(g_sigma, "g_sigma", torch.float32, (n,))
        check_condpart(unpadded, condpart, n // spr)
        dirpart = pad_dirpart(unpadded, net, dirpart)
        condpart = pad_condpart(unpadded, net.width, condpart)
        half = dirpart.shape[1]
        if net.has_vd and half != net.width // 2:
            raise ValueError(f"dirpart width {half}")
        f32 = torch.float32
        chunk = min(n, K.BWD_CHUNK_ROWS)
        n_split = max(1, min(16, chunk // 8192))
        M = min(K.SLAB_ROWS, (K.SLAB_ROWS - 1) // spr + 2)
        cw = 0 if condpart is None else condpart.shape[1]
        ws = torch.empty(chunk * bwd_workspace_cols(net), dtype=_BF,
                         device=dev)
        wpart = torch.empty((n_split, net.lay["n_w"]), dtype=f32, device=dev)
        bpart = torch.empty((chunk // K.SLAB_ROWS, net.lay["n_b"]), dtype=f32,
                            device=dev)
        dpart = torch.empty((n // K.SLAB_ROWS, M, half), dtype=f32, device=dev)
        cpart = torch.empty((n // K.SLAB_ROWS, M, cw), dtype=f32, device=dev)
        d_pts = torch.empty((n, 3), dtype=f32, device=dev)
        d_dir = (torch.empty if net.has_vd else torch.zeros)(
            (n // spr, half), dtype=f32, device=dev)
        d_cond = torch.empty((n // spr, cw), dtype=f32, device=dev)
        d_w = torch.empty(net.lay["n_w"], dtype=f32, device=dev)
        d_b = torch.empty(net.lay["n_b"], dtype=f32, device=dev)
        wp = wgpack.field_buffer(net, transposed=True)
        a0s = torch.empty(chunk * net.k0, dtype=f32, device=dev)
        masks = torch.empty((chunk // K.SLAB_ROWS + 1) * net.depth * net.width
                            * 2, dtype=torch.int32, device=dev)
        ptrs = [x.data_ptr() for x in (pts, dirpart, net.w, wp, net.b,
                                       g_rgb, g_sigma, d_pts, d_dir, d_w,
                                       d_b, ws, a0s, masks, wpart, bpart,
                                       dpart)]
        ptrs += [x.data_ptr() if cw else None
                 for x in (condpart, d_cond, cpart)]
        code = K.library().fnt_field_backward(
            *ptrs, ws.numel(), n, spr, net.L, net.depth, net.width, net.k0,
            net.skip_mask, int(net.has_vd), chunk, n_split, M, cw,
            *K.launch_args(dev))
        K.raise_on_error(code, "fnt_field_backward")
        K.LAUNCHES["field_bwd_cond" if cw else "field_bwd"] += 1
        out = (d_pts, d_dir, d_w, d_b) + ((d_cond,) if cw else ())
        if net.unpad is None:
            return out
        # the original entries' gradients; those of the padding are zeros
        pos_w, pos_b = net.unpad
        out = (d_pts, d_dir[:, :cols].contiguous(), d_w.index_select(0, pos_w),
               d_b.index_select(0, pos_b))
        if cw:
            W = unpadded.width
            out += (d_cond.reshape(n // spr, -1, net.width)[:, :, :W]
                    .reshape(n // spr, -1).contiguous(),)
        return out


class FusedField(torch.autograd.Function):
    """K3 forward and K4 backward under autograd (the reference's
    `field_core` custom VJP).

    apply(pts (n,3) f32, dirpart (n/spr, W/2) f32, condpart (n/spr,
    n_cond·W) f32 or None, w32 (n_w,) f32, b (n_b,) f32, net, spr)
    → (rgb (n,3), σ (n,)). `net` is the PackedNet that w32 and b were
    packed into; its bf16 `w` is what the kernels read. dirpart, condpart
    and w32 are rounded to bf16 here, and their gradients are returned
    unrounded (straight through the casts, as the reference's VJP returns
    f32 cotangents for its f32 params and hoists)."""

    @staticmethod
    def forward(ctx, pts, dirpart, condpart, w32, b, net, spr):
        dp = dirpart.to(_BF).contiguous()
        cp = None if condpart is None else condpart.to(_BF).contiguous()
        rgb, sigma = field_rows(net, pts, dp, spr, cp)
        ctx.save_for_backward(pts, dp, cp)
        ctx.net, ctx.spr = net, spr
        return rgb, sigma

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        pts, dp, cp = ctx.saved_tensors
        d_pts, d_dir, d_w, d_b, *d_cp = field_rows_backward(
            ctx.net, pts, dp, g_rgb.float().contiguous(),
            g_sigma.float().contiguous(), ctx.spr, cp)
        return (d_pts, d_dir, d_cp[0] if d_cp else None, d_w, d_b, None,
                None)


def make_fused_field():
    """Field fn with the reference convention:
    field(params, pts (R,S,3), viewdirs (R,3), cond (R,Cc)=None) →
    (rgb (R,S,3), σ (R,S)), where params is a NeRFMLP. Runs K3 on CUDA
    tensors (the plain version on CPU tensors); a cond enters as its
    per-ray condpart cond @ cond_kernel. With grad enabled it runs through
    FusedField, whose backward is K4 (or its plain version), and gradients
    reach the NeRFMLP's parameters and the cond."""

    def field(params: NeRFMLP, pts, viewdirs, cond=None):
        net = pack_params(params, hoist_x=False)
        R, S = pts.shape[0], pts.shape[1]
        step = K.SLAB_ROWS // math.gcd(S, K.SLAB_ROWS)
        R_pad = -(-R // step) * step
        flat = F.pad(pts.reshape(R, S, 3), (0, 0, 0, 0, 0, R_pad - R))
        flat = flat.reshape(-1, 3).contiguous()
        dterm = F.pad(dir_term(net, viewdirs), (0, 0, 0, R_pad - R))
        # the hoist in f32, rounded to bf16 where the kernel takes it
        cterm = (None if cond is None else F.pad(
            cond_term(net, cond), (0, 0, 0, R_pad - R)).contiguous())
        if net.w32 is not None:
            rgb, sigma = FusedField.apply(flat, dterm.contiguous(), cterm,
                                          net.w32, net.b, net, S)
        else:
            rgb, sigma = field_rows(net, flat, dterm.to(_BF).contiguous(), S,
                                    None if cterm is None
                                    else cterm.to(_BF).contiguous())
        return (rgb[:R * S].reshape(R, S, 3), sigma[:R * S].reshape(R, S))

    return field


def field_for(cfg, training: bool = False):
    """The field fn (`make_fused_field`'s convention) cfg runs its NeRFMLPs
    through, for inference or for training: the fused field where
    `config.takes_fused_field`, else `module_field`."""
    return (make_fused_field() if takes_fused_field(cfg, training)
            else module_field)
