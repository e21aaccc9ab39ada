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

Training (`wide_field_train`, an autograd Function over a MipMLP's
parameters): the forward is the render's kernels with every trunk layer's
output kept in the activation layout, beside its ReLU bits, and the head's
bottleneck and view outputs (`_run_forward_train`, one call for all rows);
the backward (`_run_backward`, csrc/widefield.cu's design notes) gives
every weight's and bias's gradient in f32, summed over the rows in a fixed
order, and the per-ray view term's cotangent, whose W_dir gradient is one
product after it. Its numerics are autograd's through `wide_rows_plain`:
each kept activation's cotangent rounded to bf16 and masked by its ReLU,
f32 products and sums, the weights' rounding passed through
(`wide_bwd_plain`, the plain version). Each backward call adds one to
LAUNCHES["wide_field_bwd"] and runs inside "fnt.kernel.wide_field_bwd" or
"fnt.kernel.prop_field_bwd". The IPE depends on no parameter: no
gradient flows to the Gaussians or the view directions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.cones import ipe, viewdir_encoding
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
    wpt: Optional[torch.Tensor] = None  # bf16, the backward's slices

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


def _slices(full, tile_n: int = TILE_N):
    """A (K, N) weight matrix (K a multiple of 64, N of tile_n) → its 64 ×
    tile_n slices in wgpack's core-matrix order, output column block
    outermost, then K: one flat bf16 buffer (wgpack._tile of each slice)."""
    K_, N = full.shape
    return full.to(_BF).reshape(K_ // 64, 8, 8, N // tile_n, tile_n // 8,
                                8).permute(3, 0, 4, 1, 5, 2).reshape(-1)


def _ipe_rows(w_a):
    """A layer's IPE rows (6L, W), zero-padded to IPE_COLS rows."""
    return torch.cat([w_a, w_a.new_zeros(IPE_COLS - w_a.shape[0],
                                         w_a.shape[1])])


def _kernel_buffers(net: PackedWide, dev):
    """K7's (wp, b) of a packed net (module docstring, `wide_layout`)."""
    W = net.width
    lay = wide_layout(net.depth, W, net.skips, net.has_vd)
    wp = torch.zeros(lay["n_wp"], dtype=_BF, device=dev)
    b = torch.zeros(lay["n_b"], dtype=torch.float32, device=dev)

    def put(off, flat):
        wp[off:off + flat.numel()] = flat
        return off + flat.numel()

    for i in range(net.depth):
        off, kb_h, kb_a = lay["layers"][i]
        rows = [net.w_h[i]] if kb_h else []
        if kb_a:
            rows.append(_ipe_rows(net.w_a[i]))
        put(off, _slices(torch.cat(rows)))
        b[lay["b"][i]:lay["b"][i] + W] = net.bias[i]
    h = net.heads
    b[lay["sig"]:lay["sig"] + W] = h["sig"]
    b[lay["b_sig"]] = h["b_sig"]
    if net.has_vd:
        off = put(lay["bn"], _slices(h["bn"], HEAD_BOTTLENECK))
        put(off, _slices(h["vb"], HEAD_VIEW))
        for key, n in (("b_bn", HEAD_BOTTLENECK), ("b_view", HEAD_VIEW),
                       ("rgb", 3 * HEAD_VIEW), ("b_rgb", 3)):
            b[lay[key]:lay[key] + n] = h[key].reshape(-1)
    return wp, b


def _bwd_buffers(net: PackedWide):
    """The backward's B operands: each trunk layer's W_hᵀ (layers 1 …, W × W
    each), then with a view branch the bottleneck's W_bnᵀ (256 × W) and the
    view layer's W_vbᵀ (128 × 256), sliced as the forward's are."""
    parts = [_slices(net.w_h[i].t()) for i in range(1, net.depth)]
    if net.has_vd:
        parts += [_slices(net.heads["bn"].t()),
                  _slices(net.heads["vb"].t())]
    return torch.cat(parts).contiguous()


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


def wide_rows_plain(net: PackedWide, mean, var, dirpart, spr: int,
                    keep: Optional[dict] = None):
    """The plain version of K7: Gaussians mean, var (n, 3) f32, dirpart
    (n / spr, view width) f32 (None without a view branch) → (rgb (n, 3)
    or None, raw σ (n,)). keep: a dict that receives what the backward
    reads (the IPE operand "a0", every trunk layer's output "hs", the
    bottleneck "bn", the view layer "v" and the sigmoid "s")."""
    def _bf(x):
        return _round(x, net.bf16)

    a0 = _bf(ipe(mean, var, net.L))
    h, hs = None, []
    for i in range(net.depth):
        acc = 0.0
        if net.w_h[i] is not None:
            acc = h @ net.w_h[i]
        if net.w_a[i] is not None:
            acc = acc + a0 @ net.w_a[i]
        h = _bf(torch.relu(acc + net.bias[i]))
        hs.append(h)
    hd = net.heads
    sigma = h @ hd["sig"] + hd["b_sig"]
    if keep is not None:
        keep.update(a0=a0, hs=hs)
    if not net.has_vd:
        return None, sigma
    bn = _bf(h @ hd["bn"] + hd["b_bn"])
    v = _bf(torch.relu(bn @ hd["vb"] + dirpart.repeat_interleave(spr, dim=0)
                       + hd["b_view"]))
    s = torch.sigmoid(v @ hd["rgb"] + hd["b_rgb"])
    if keep is not None:
        keep.update(bn=bn, v=v, s=s)
    return s * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING, sigma


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


# --- training: the forward that keeps its activations, and the backward ----

def wide_bwd_plain(net: PackedWide, saved: dict, g_rgb, g_sigma,
                   spr: int) -> dict:
    """The plain version of K7's backward: the cotangents of rgb (n, 3) (a
    view branch) and raw σ (n,) back through the net of `saved` (what
    `wide_rows_plain(..., keep=saved)` kept) → the gradients of the packed
    net's weights, as `pack_wide` holds them (in × out): "w_h", "w_a",
    "bias" (lists per layer; w_a of its 6L rows), "sig", "b_sig", and with
    a view branch "bn", "b_bn", "vb", "b_view", "rgb", "b_rgb" and the
    per-ray view term's cotangent "dirpart" (n / spr, view width).

    Rounding points as autograd through `wide_rows_plain` sets them: the
    cotangent of every bf16-rounded activation is rounded to bf16 (the
    operand of both products), masked by its ReLU (from the kept output);
    products and sums are f32; the weights' rounding passes the gradient
    through as it is."""
    def _bf(x):
        return _round(x, net.bf16)

    hd, hs, a0 = net.heads, saved["hs"], saved["a0"]
    h = hs[-1]
    out = {"sig": h.t() @ g_sigma, "b_sig": g_sigma.sum().reshape(1)}
    g_h = g_sigma[:, None] * hd["sig"][None, :]
    if net.has_vd:
        s, v, bn = saved["s"], saved["v"], saved["bn"]
        g_logit = g_rgb * (1.0 + 2.0 * RGB_PADDING) * s * (1.0 - s)
        out.update(rgb=v.t() @ g_logit, b_rgb=g_logit.sum(0))
        dzv = torch.where(v > 0, _bf(g_logit @ hd["rgb"].t()), 0.0)
        out.update(vb=bn.t() @ dzv, b_view=dzv.sum(0),
                   dirpart=dzv.reshape(-1, spr, dzv.shape[1]).sum(1))
        dbn = _bf(dzv @ hd["vb"].t())
        out.update(bn=h.t() @ dbn, b_bn=dbn.sum(0))
        g_h = g_h + dbn @ hd["bn"].t()
    w_h, w_a, bias = ([None] * net.depth for _ in range(3))
    for i in range(net.depth - 1, -1, -1):
        dz = torch.where(hs[i] > 0, _bf(g_h), 0.0)
        bias[i] = dz.sum(0)
        if net.w_h[i] is not None:
            w_h[i] = hs[i - 1].t() @ dz
            g_h = dz @ net.w_h[i].t()
        if net.w_a[i] is not None:
            w_a[i] = a0.t() @ dz
    out.update(w_h=w_h, w_a=w_a, bias=bias)
    return out


def untile_rows(buf, n: int, cols: int):
    """K7's activation layout ((n/64, cols/64) blocks of 64 × 64 in wgmma's
    core-matrix order) → (n, cols) f32, row-major."""
    return buf.view(n // 64, cols // 64, 8, 8, 8, 8).permute(
        0, 2, 4, 1, 3, 5).reshape(n, cols).float()


def plain_saved(net: PackedWide, saved: dict, n: int) -> dict:
    """What `_run_forward_train` kept on n rows, in the form
    `wide_bwd_plain` reads (f32, row-major)."""
    hs = saved["hs"].view(net.depth, -1)
    out = {"a0": untile_rows(saved["a0"], n, IPE_COLS)[:, :6 * net.L],
           "hs": [untile_rows(hs[i], n, net.width)
                  for i in range(net.depth)]}
    if net.has_vd:
        out.update(bn=untile_rows(saved["bn"], n, HEAD_BOTTLENECK),
                   v=untile_rows(saved["v"], n, HEAD_VIEW),
                   s=(saved["rgb"] + RGB_PADDING) / (1.0 + 2.0 * RGB_PADDING))
    return out


def _run_forward_train(net: PackedWide, mean, var, dirpart, spr: int):
    """K7's training forward on the card: every row in one call, the
    layers' outputs kept → (rgb, σ, saved)."""
    dev = mean.device
    n, W = mean.shape[0], net.width
    if n % (2 * K.SLAB_ROWS) or spr < 1 or n % spr:
        raise ValueError(f"K7 takes rows in multiples of 128 and of spr: "
                         f"n={n}, spr={spr}")
    K.check(mean, "mean", torch.float32, (n, 3))
    K.check(var, "var", torch.float32, (n, 3))
    if net.has_vd:
        K.check(dirpart, "dirpart", torch.float32, (n // spr, HEAD_VIEW))
    hs = torch.empty(net.depth * n * W, dtype=_BF, device=dev)
    # each layer's ReLU bits, a bit an output (dgrad's mask)
    masks = torch.empty(net.depth * n * W // 32, dtype=torch.int32,
                        device=dev)
    a0 = torch.empty(n * IPE_COLS, dtype=_BF, device=dev)
    part = torch.empty(n * (W // TILE_N), dtype=torch.float32, device=dev)
    sigma = torch.empty((n,), dtype=torch.float32, device=dev)
    saved = {"a0": a0, "hs": hs, "masks": masks}
    rgb = bn = v = None
    if net.has_vd:
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        bn = torch.empty(n * HEAD_BOTTLENECK, dtype=_BF, device=dev)
        v = torch.empty(n * HEAD_VIEW, dtype=_BF, device=dev)
        # rgb detached: the output itself would tie the graph's node to
        # the saved state in a cycle that only the garbage collector frees
        saved.update(bn=bn, v=v, rgb=rgb.detach())
    code = K.library().fnt_wide_field_train(
        mean.data_ptr(), var.data_ptr(),
        dirpart.data_ptr() if net.has_vd else None, net.wp.data_ptr(),
        net.b.data_ptr(), hs.data_ptr(), masks.data_ptr(), a0.data_ptr(),
        part.data_ptr(), rgb.data_ptr() if net.has_vd else None,
        sigma.data_ptr(),
        bn.data_ptr() if net.has_vd else None,
        v.data_ptr() if net.has_vd else None, n, spr, net.L, net.depth, W,
        net.skip_mask, int(net.has_vd), *K.launch_args(dev))
    K.raise_on_error(code, "fnt_wide_field_train")
    K.LAUNCHES["wide_field"] += 1
    return rgb, sigma, saved


# the weight-gradient kernel's partial sums, at most this many floats
WGRAD_PART_FLOATS = 1 << 25
# a warpgroup's partials of the head's backward: the rgb head, the view
# bias, the rgb bias (padded to 4)
HEAD_PART = 3 * HEAD_VIEW + HEAD_VIEW + 4


def _run_backward(net: PackedWide, saved: dict, g_rgb, g_sigma,
                  spr: int) -> dict:
    """K7's backward on the card → `wide_bwd_plain`'s dict."""
    dev = g_sigma.device
    n, W, D = g_sigma.shape[0], net.width, net.depth
    if net.has_vd and (64 % spr):
        raise ValueError(f"K7's backward sums the view term over rays of "
                         f"a divisor of 64 rows, not {spr}")
    if net.wpt is None:
        net.wpt = _bwd_buffers(net)
    # the gradients, one f32 buffer: per layer its [h | IPE (IPE_COLS
    # rows)] × W block, the bottleneck and view layer; then the vectors
    offs, at = [], 0

    def take(k):
        nonlocal at
        offs.append(at)
        at += k

    k_in = [(W if i > 0 else 0) + (IPE_COLS if net.w_a[i] is not None
                                   else 0) for i in range(D)]
    for i in range(D):
        take(k_in[i] * W)
    take(W * HEAD_BOTTLENECK)
    take(HEAD_BOTTLENECK * HEAD_VIEW)
    for i in range(D):
        take(W)
    for k in (W, HEAD_BOTTLENECK, HEAD_VIEW, 3 * HEAD_VIEW, 4):
        take(k)
    grad = torch.zeros(at, dtype=torch.float32, device=dev)
    n_rays = n // spr
    d_dir = (torch.empty((n_rays, HEAD_VIEW), dtype=torch.float32,
                         device=dev) if net.has_vd else None)
    dz = torch.empty(2 * n * W, dtype=_BF, device=dev)
    dbn = dzv = None
    if net.has_vd:
        dbn = torch.empty(n * HEAD_BOTTLENECK, dtype=_BF, device=dev)
        dzv = torch.empty(n * HEAD_VIEW, dtype=_BF, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cpart = torch.empty(n_sm * (2 * max(W, HEAD_BOTTLENECK)
                                + 2 * HEAD_PART), dtype=torch.float32,
                        device=dev)
    wpart = torch.empty(WGRAD_PART_FLOATS, dtype=torch.float32, device=dev)
    arr = ctypes.cast((ctypes.c_long * len(offs))(*offs), ctypes.c_void_p)
    code = K.library().fnt_wide_field_backward(
        saved["a0"].data_ptr(), saved["hs"].data_ptr(),
        saved["masks"].data_ptr(),
        saved["bn"].data_ptr() if net.has_vd else None,
        saved["v"].data_ptr() if net.has_vd else None,
        saved["rgb"].data_ptr() if net.has_vd else None,
        g_rgb.data_ptr() if net.has_vd else None, g_sigma.data_ptr(),
        net.wpt.data_ptr(), net.b.data_ptr(), dz.data_ptr(),
        dbn.data_ptr() if net.has_vd else None,
        dzv.data_ptr() if net.has_vd else None, cpart.data_ptr(),
        wpart.data_ptr(), WGRAD_PART_FLOATS, grad.data_ptr(), arr,
        d_dir.data_ptr() if net.has_vd else None, n, spr, D, W,
        net.skip_mask, int(net.has_vd), *K.launch_args(dev))
    K.raise_on_error(code, "fnt_wide_field_backward")
    K.LAUNCHES["wide_field_bwd"] += 1
    cx = 6 * net.L
    out = {"w_h": [], "w_a": [], "bias": []}
    for i in range(D):
        blk = grad[offs[i]:offs[i] + k_in[i] * W].view(k_in[i], W)
        kh = W if i > 0 else 0
        out["w_h"].append(blk[:kh] if i > 0 else None)
        out["w_a"].append(blk[kh:kh + cx] if net.w_a[i] is not None
                          else None)
        out["bias"].append(grad[offs[D + 2 + i]:offs[D + 2 + i] + W])
    o = offs[2 * D + 2:]
    out.update(sig=grad[o[0]:o[0] + W], b_sig=g_sigma.sum().reshape(1))
    if net.has_vd:
        out.update(
            bn=grad[offs[D]:offs[D] + W * HEAD_BOTTLENECK].view(
                W, HEAD_BOTTLENECK),
            vb=grad[offs[D + 1]:offs[D + 1] + HEAD_BOTTLENECK * HEAD_VIEW]
            .view(HEAD_BOTTLENECK, HEAD_VIEW),
            b_bn=grad[o[1]:o[1] + HEAD_BOTTLENECK],
            b_view=grad[o[2]:o[2] + HEAD_VIEW],
            rgb=grad[o[3]:o[3] + 3 * HEAD_VIEW].view(HEAD_VIEW, 3),
            b_rgb=grad[o[4]:o[4] + 3], dirpart=d_dir)
    return out


def _param_grads(net: MipMLP, packed: PackedWide, g: dict, viewdirs):
    """`wide_bwd_plain`'s dict → the gradients of net.parameters(), in
    their order (named_dense: weight (out, in), then bias)."""
    out = []
    for i in range(net.depth):
        rows = ([g["w_h"][i]] if g["w_h"][i] is not None else []) + (
            [g["w_a"][i]] if g["w_a"][i] is not None else [])
        out += [torch.cat(rows).t(), g["bias"][i]]
    out += [g["sig"][None, :], g["b_sig"]]
    if net.has_vd:
        enc = viewdir_encoding(viewdirs, packed.L_dir)
        out += [g["bn"].t(), g["b_bn"],
                torch.cat([g["vb"], enc.t() @ g["dirpart"]]).t(),
                g["b_view"], g["rgb"].t(), g["b_rgb"]]
    return out


def _packed(net: MipMLP, bf16: bool) -> PackedWide:
    """`pack_wide(net, bf16)`, kept on the module until a parameter changes
    (its version counter moves with every in-place update): the proposal
    MLP runs twice a step on one packing, and the backward's transposed
    slices are built once a step."""
    key = (bf16,) + tuple((p.data_ptr(), p._version)
                          for p in net.parameters())
    hit = net.__dict__.get("_k7_packed")
    if hit is None or hit[0] != key:
        hit = (key, pack_wide(net, bf16))
        net.__dict__["_k7_packed"] = hit
    return hit[1]


class _WideField(torch.autograd.Function):
    """K7 under autograd: the forward keeps its activations, the backward
    gives every parameter's gradient (none to the Gaussians or the view
    directions, which depend on no parameter). CPU tensors: the plain
    versions; CUDA tensors: the kernels."""

    @staticmethod
    def forward(ctx, net, bf16, spr, mean, var, viewdirs, *params):
        packed = _packed(net, bf16)
        dirpart = (dir_term(packed, viewdirs).contiguous() if net.has_vd
                   else None)
        dev = K.on_cuda(mean, var)
        name = "fnt.kernel.wide_field" if net.has_vd else \
            "fnt.kernel.prop_field"
        if dev is None:
            saved = {}
            rgb, sigma = wide_rows_plain(packed, mean, var, dirpart, spr,
                                         keep=saved)
        else:
            with span(name):
                if packed.wp is None:
                    raise ValueError("K7 computes in bf16 at the widths "
                                     "`check_wide_shape` takes")
                rgb, sigma, saved = _run_forward_train(packed, mean, var,
                                                       dirpart, spr)
        ctx.state = (net, packed, saved, spr, viewdirs, dev)
        if rgb is None:
            return sigma
        return rgb, sigma

    @staticmethod
    def backward(ctx, *grads):
        net, packed, saved, spr, viewdirs, dev = ctx.state
        g_rgb, g_sigma = grads if net.has_vd else (None, grads[0])
        n = saved["a0"].shape[0] if dev is None else \
            saved["a0"].numel() // IPE_COLS
        like = saved["a0"]
        g_sigma = (like.new_zeros((n,), dtype=torch.float32)
                   if g_sigma is None else g_sigma.float().contiguous())
        if net.has_vd and g_rgb is None:
            g_rgb = like.new_zeros((n, 3), dtype=torch.float32)
        elif net.has_vd:
            g_rgb = g_rgb.float().contiguous()
        if dev is None:
            g = wide_bwd_plain(packed, saved, g_rgb, g_sigma, spr)
        else:
            name = ("fnt.kernel.wide_field_bwd" if net.has_vd
                    else "fnt.kernel.prop_field_bwd")
            with span(name):
                g = _run_backward(packed, saved, g_rgb, g_sigma, spr)
        return (None, None, None, None, None, None,
                *_param_grads(net, packed, g, viewdirs))


def wide_field_train(net: MipMLP, mean, var, viewdirs, spr: int,
                     bf16: bool = True):
    """A MipMLP on n rows for training (rows of a ray consecutive, spr a
    ray; viewdirs (n / spr, 3) with a view branch, else None) → (rgb (n, 3)
    or None, raw σ (n,)), differentiable in the net's parameters: K7's
    training forward and backward on CUDA tensors, their plain versions on
    CPU tensors. Each forward call adds one to LAUNCHES["wide_field"] on the
    card, each backward one to LAUNCHES["wide_field_bwd"]."""
    out = _WideField.apply(net, bf16, spr, mean.contiguous(),
                           var.contiguous(), viewdirs, *net.parameters())
    return out if net.has_vd else (None, out)
