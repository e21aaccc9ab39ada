"""The wide field (kernel K7, csrc/widefield.cu): the nets of mip-NeRF 360
on the integrated encoding of contracted cone Gaussians, and its plain
PyTorch version.

K7 replaces no TPU kernel: the JAX package has no mip-NeRF 360. It exists
because the field kernels K3, K4 and K6 keep a row tile's activations on
the chip between layers, which stops at width 256 (64 rows in and out at
width 1024 are 256 KB, above a block's 227 KB of shared memory). K7 runs
the trunk layer by layer instead: each layer is a matrix product over the
whole launch, its activations written to device memory in the tiled layout
the next layer's product reads (64 × 64 bf16 blocks in wgmma's core-matrix
order, so that one bulk copy brings a block into shared memory). Widths
256 (the 4×256 proposal) and 1024 (the 8×1024 NeRF MLP), depths 4 and 8,
one skip layer, and the NeRF MLP's head (the 256-wide bottleneck, the
128-wide view layer on it and the per-ray view term, rgb). The IPE operand
(6L features padded with zeros to IPE_COLS columns) is written by a small
kernel of K7's own from the Gaussians' means and variances.

Buffers (`wide_layout`, the same arithmetic as csrc/widefield.cu): `wp`
holds, for each trunk layer and each 256-column block of its output, the
layer's rows [h (W) | IPE (IPE_COLS, zero-padded)] in 64-row slices, each
a 64 × 256 tile in wgpack's core-matrix order; then the bottleneck's
slices and the view layer's four 64 × 128 slices. `b` holds the trunk's
biases, the σ head (bf16-rounded, as f32) and its bias, and with a view
branch the bottleneck's and view layer's biases, the rgb head (128 × 3,
bf16-rounded) and its bias.

Numerics (kernel and plain version alike): bf16 operands rounded to
nearest even, f32 accumulation, activations rounded to bf16 after the ReLU
(the bottleneck after its bias, with no activation); σ and the rgb head
are f32 dot products of the bf16 activations with the bf16-rounded heads;
the IPE in f32, rounded to bf16 as the operand. The per-ray view term
dirpart = γ(d̂) @ W_dir is f32.

Path rule (kernels/__init__.py): CPU tensors take `wide_rows_plain`, CUDA
tensors K7. Each call of the entry adds one to LAUNCHES["wide_field"]; on
the CUDA path the launches run inside the host range
"fnt.kernel.wide_field" for a net with a view branch (the NeRF MLP) and
"fnt.kernel.prop_field" for one without (the proposal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.cones import ipe, viewdir_encoding
from fashion_nerf_torch.kernels.wgpack import _tile
from fashion_nerf_torch.models.mipnerf360 import RGB_PADDING, MipMLP
from fashion_nerf_torch.trace import span

_BF = torch.bfloat16
IPE_COLS = 128              # the IPE operand's padded width
WIDE_WIDTHS = (256, 1024)
WIDE_DEPTHS = (4, 8)
HEAD_BOTTLENECK, HEAD_VIEW = 256, 128
TILE_N = 256                # output columns of one product tile
# rows of one call of the entry: its workspace is two activation buffers
# (8 GB at width 1024) and the IPE operand
WIDE_CHUNK_ROWS = 1 << 21


def _round(x, bf16: bool):
    """x rounded to bf16 (nearest even) in its own dtype, or x."""
    return x.to(_BF).to(x.dtype) if bf16 else x


def wide_layout(depth: int, width: int, skips, has_vd: bool) -> dict:
    """Element offsets into `wp` and `b` (see the module docstring)."""
    wo, layers = 0, []
    for i in range(depth):
        kb_h = width // 64 if i > 0 else 0
        kb_a = IPE_COLS // 64 if (i == 0 or (i - 1) in skips) else 0
        layers.append((wo, kb_h, kb_a))
        wo += (width // TILE_N) * (kb_h + kb_a) * 64 * TILE_N
    lay = {"layers": layers, "b": [i * width for i in range(depth)],
           "sig": depth * width, "b_sig": depth * width + width}
    bo = lay["b_sig"] + 4
    if has_vd:
        lay["bn"] = wo
        wo += (width // 64) * 64 * HEAD_BOTTLENECK
        lay["view"] = wo
        wo += HEAD_BOTTLENECK * HEAD_VIEW
        lay["b_bn"] = bo
        lay["b_view"] = bo + HEAD_BOTTLENECK
        lay["rgb"] = lay["b_view"] + HEAD_VIEW
        lay["b_rgb"] = lay["rgb"] + 3 * HEAD_VIEW
        bo = lay["b_rgb"] + 4
    lay["n_wp"], lay["n_b"] = wo, bo
    return lay


@dataclass
class PackedWide:
    """A MipMLP with its weights rounded to bf16: f32 views of them for the
    plain version (any widths), and K7's buffers where K7 takes the net
    (`check_wide_shape`; else wp and b are None). Packed with bf16=False
    (a float32 config), nothing is rounded: the plain version is then the
    float32 net, and K7, which computes in bf16, refuses it."""
    bf16: bool
    depth: int
    width: int
    skips: tuple
    L: int                      # IPE degree
    L_dir: int
    has_vd: bool
    w_h: list                   # (W, W) f32 or None, per layer
    w_a: list                   # (6L, W) f32 or None, per layer
    bias: list                  # (W,) f32, per layer
    heads: dict                 # sig (W,), b_sig, and with a view branch
    #                             bn, b_bn, vb, dir, b_view, rgb, b_rgb
    wp: Optional[torch.Tensor] = None   # bf16, the kernel's slices
    b: Optional[torch.Tensor] = None    # f32, the kernel's biases and heads

    @property
    def skip_mask(self) -> int:
        """Bit i for each layer i > 0 that takes the IPE operand again."""
        return sum(1 << (i + 1) for i in self.skips)


def check_wide_shape(width: int, depth: int, skips, L: int,
                     bottleneck: int = 0, view: int = 0) -> None:
    """Raise unless K7 takes the net: width 256 or 1024, depth 4 or 8, at
    most one skip layer, 6L ≤ IPE_COLS, and a head of 256 → 128."""
    if width not in WIDE_WIDTHS or depth not in WIDE_DEPTHS:
        raise ValueError(f"K7 takes widths {WIDE_WIDTHS} and depths "
                         f"{WIDE_DEPTHS}, not {width}×{depth}")
    if len(skips) > 1 or any(not 0 <= s < depth - 1 for s in skips):
        raise ValueError(f"K7 takes one skip layer inside the trunk, not "
                         f"{tuple(skips)}")
    if not 0 < 6 * L <= IPE_COLS:
        raise ValueError(f"IPE degree {L}: 6L must lie in 1..{IPE_COLS}")
    if bottleneck and (bottleneck, view) != (HEAD_BOTTLENECK, HEAD_VIEW):
        raise ValueError(f"K7's head is {HEAD_BOTTLENECK} → {HEAD_VIEW}, not "
                         f"{bottleneck} → {view}")


def _kernel_buffers(net: PackedWide, dev):
    """K7's (wp, b) of a packed net (module docstring, `wide_layout`)."""
    W, cx = net.width, 6 * net.L
    lay = wide_layout(net.depth, W, net.skips, net.has_vd)
    wp = torch.zeros(lay["n_wp"], dtype=_BF, device=dev)
    b = torch.zeros(lay["n_b"], dtype=torch.float32, device=dev)

    def put(off, k):
        wp[off:off + k.numel()] = _tile(k.to(_BF))
        return off + k.numel()

    for i in range(net.depth):
        off, kb_h, kb_a = lay["layers"][i]
        rows = [net.w_h[i]] if kb_h else []
        if kb_a:
            ka = net.w_a[i]
            rows.append(torch.cat([ka, ka.new_zeros(IPE_COLS - cx, W)]))
        full = torch.cat(rows)
        for nt in range(W // TILE_N):
            for kb in range(full.shape[0] // 64):
                off = put(off, full[kb * 64:(kb + 1) * 64,
                                    nt * TILE_N:(nt + 1) * TILE_N])
        b[lay["b"][i]:lay["b"][i] + W] = net.bias[i]
    h = net.heads
    b[lay["sig"]:lay["sig"] + W] = h["sig"]
    b[lay["b_sig"]] = h["b_sig"]
    if net.has_vd:
        off = lay["bn"]
        for src in (h["bn"], h["vb"]):
            for kb in range(src.shape[0] // 64):
                off = put(off, src[kb * 64:(kb + 1) * 64])
        for key, n in (("b_bn", HEAD_BOTTLENECK), ("b_view", HEAD_VIEW),
                       ("rgb", 3 * HEAD_VIEW), ("b_rgb", 3)):
            b[lay[key]:lay[key] + n] = h[key].reshape(-1)
    return wp, b


def pack_wide(net: MipMLP, bf16: bool = True) -> PackedWide:
    """Pack a MipMLP on its parameters' device: the plain version's views,
    and K7's buffers where K7 takes its shape (bf16 only)."""
    W = net.width

    def _bf(x):
        return _round(x, bf16)

    with torch.no_grad():
        w_h, w_a, bias = [], [], []
        for i, layer in enumerate(net.trunk):
            k = _bf(layer.weight.t().float())          # (in, W)
            w_h.append(k[:W] if i > 0 else None)
            w_a.append(k[W:] if i > 0 else k)
            if i > 0 and k.shape[0] == W:
                w_a[-1] = None
            bias.append(layer.bias.float().clone())
        heads = {"sig": _bf(net.sigma_head.weight[0].float()),
                 "b_sig": net.sigma_head.bias[0].float().clone()}
        if net.has_vd:
            kv = _bf(net.view_0.weight.t().float())
            heads.update(bn=_bf(net.feature.weight.t().float()),
                         b_bn=net.feature.bias.float().clone(),
                         vb=kv[:net.bottleneck].contiguous(),
                         dir=kv[net.bottleneck:].contiguous(),
                         b_view=net.view_0.bias.float().clone(),
                         rgb=_bf(net.rgb_head.weight.t().float()),
                         b_rgb=net.rgb_head.bias.float().clone())
        packed = PackedWide(bf16=bf16, depth=net.depth, width=W,
                            skips=net.skips,
                            L=net.ipe_deg, L_dir=net.dir_deg,
                            has_vd=net.has_vd, w_h=w_h, w_a=w_a, bias=bias,
                            heads=heads)
        try:
            check_wide_shape(W, net.depth, net.skips, net.ipe_deg,
                             net.bottleneck, net.view_width)
        except ValueError:
            return packed
        if not bf16:
            return packed
        packed.wp, packed.b = _kernel_buffers(packed,
                                              net.trunk[0].weight.device)
    return packed


def dir_term(net: PackedWide, viewdirs):
    """Per-ray view term γ(d̂) @ W_dir → (R, view width) f32."""
    return viewdir_encoding(viewdirs, net.L_dir) @ net.heads["dir"]


def wide_rows_plain(net: PackedWide, mean, var, dirpart, spr: int):
    """The plain version of K7: Gaussians mean, var (n, 3) f32, dirpart
    (n / spr, view width) f32 (None without a view branch) → (rgb (n, 3)
    or None, raw σ (n,))."""
    def _bf(x):
        return _round(x, net.bf16)

    a0 = _bf(ipe(mean, var, net.L))
    h = None
    for i in range(net.depth):
        acc = 0.0
        if net.w_h[i] is not None:
            acc = h @ net.w_h[i]
        if net.w_a[i] is not None:
            acc = acc + a0 @ net.w_a[i]
        h = _bf(torch.relu(acc + net.bias[i]))
    hd = net.heads
    sigma = h @ hd["sig"] + hd["b_sig"]
    if not net.has_vd:
        return None, sigma
    bn = _bf(h @ hd["bn"] + hd["b_bn"])
    v = _bf(torch.relu(bn @ hd["vb"] + dirpart.repeat_interleave(spr, dim=0)
                       + hd["b_view"]))
    rgb = torch.sigmoid(v @ hd["rgb"] + hd["b_rgb"])
    return rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING, sigma


def wide_rows(net: PackedWide, mean, var, dirpart, spr: int):
    """K7 on n rows (a multiple of 128; the rows of a ray consecutive, spr
    a ray) → (rgb (n, 3) or None, raw σ (n,)). CPU tensors: the plain
    version; CUDA tensors: the kernel, in calls of at most WIDE_CHUNK_ROWS
    rows."""
    dev = K.on_cuda(mean, var, dirpart)
    if dev is None:
        return wide_rows_plain(net, mean, var, dirpart, spr)
    name = "fnt.kernel.wide_field" if net.has_vd else "fnt.kernel.prop_field"
    with span(name):
        if not net.bf16:
            raise ValueError("K7 computes in bf16: a float32 net runs on the "
                             "CPU only")
        if net.wp is None:
            check_wide_shape(net.width, net.depth, net.skips, net.L,
                             net.heads["bn"].shape[1] if net.has_vd else 0,
                             net.heads["vb"].shape[1] if net.has_vd else 0)
        K.on_cuda(mean, net.wp)
        n = mean.shape[0]
        if (n % (2 * K.SLAB_ROWS) or spr < 1 or n % spr
                or WIDE_CHUNK_ROWS % spr):
            raise ValueError(f"K7 takes rows in multiples of 128 and of spr "
                             f"(a divisor of {WIDE_CHUNK_ROWS}): n={n}, "
                             f"spr={spr}")
        K.check(mean, "mean", torch.float32, (n, 3))
        K.check(var, "var", torch.float32, (n, 3))
        if net.has_vd:
            K.check(dirpart, "dirpart", torch.float32, (n // spr, HEAD_VIEW))
        W, nt = net.width, net.width // TILE_N
        m = min(n, WIDE_CHUNK_ROWS)
        h0 = torch.empty(m * W, dtype=_BF, device=dev)
        h1 = torch.empty(m * W, dtype=_BF, device=dev)
        a0 = torch.empty(m * IPE_COLS, dtype=_BF, device=dev)
        part = torch.empty(m * nt, dtype=torch.float32, device=dev)
        rgb = (torch.empty((n, 3), dtype=torch.float32, device=dev)
               if net.has_vd else None)
        sigma = torch.empty((n,), dtype=torch.float32, device=dev)
        lib = K.library()
        for r0 in range(0, n, m):
            rows = min(m, n - r0)
            code = lib.fnt_wide_field(
                K.row_ptr(mean, r0), K.row_ptr(var, r0),
                K.row_ptr(dirpart, r0 // spr) if net.has_vd else None,
                net.wp.data_ptr(), net.b.data_ptr(), h0.data_ptr(),
                h1.data_ptr(), a0.data_ptr(), part.data_ptr(),
                K.row_ptr(rgb, r0), K.row_ptr(sigma, r0), rows, spr, net.L,
                net.depth, W, net.skip_mask, int(net.has_vd),
                *K.launch_args(dev))
            K.raise_on_error(code, "fnt_wide_field")
            K.LAUNCHES["wide_field"] += 1
        return rgb, sigma
