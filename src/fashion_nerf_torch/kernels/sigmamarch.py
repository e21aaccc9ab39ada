"""σ-only single-block proposal march (kernel K1, csrc/sigmamarch.cu).

Counterpart of `fashion_nerf.kernels.sigmamarch_pallas` (`pack_sigma`,
`hoist_rays`, `_sigma_kernel`). The proposal net (2×128, L=6, out_head σ
lane 3, as shipped; the reference takes any width and depth) marches ONE
block of SB samples per ray. The posenc phases and the first layer's
x-path are linear in t, so their per-ray parts are hoisted:

    P(row)    = [tile(o)·fmat + phase] + [tile(d)·fmat]·t        (f32)
    accx(row) = [o@Wx + b0]            + [d@Wx]·t                (f32)

Predication is per tile of TILE_ROWS // SB rays (32 at SB=64), as in the
reference: a tile with any alive ray is marched whole; a dead tile writes
w = 0, acc = 0, logT = 0.

On the card the march takes one of two kernels (`sigma_kernel`): K1, which
keeps the whole net resident in shared memory, at its width 128; any other
width goes to K2 without a view branch (csrc/slimmarch.cu) as one block
of SB samples, zero-padded to K2's nearest width (a 2×256 net's slices and
activations would not fit K1's shared memory beside each other; K2
streams its layers through a ring and computes K1's weights bit for bit
on the same net). The plain version runs the unpadded net either way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels.posenc_mlp import (PackedNet, _bf,
                                                   mlp_rows, pack_params,
                                                   phase_consts)
from fashion_nerf_torch.kernels.wgpack import march_buffer
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP

_LOG_FLOOR = -23.025851   # log(1e-10) floor on log(1 - α)


def pack_sigma(model: NeRFMLP) -> PackedNet:
    """Pack a σ-only proposal net (no skip, no view branch)."""
    net = pack_params(model, hoist_x=True)
    if net.skips or net.has_vd:
        raise ValueError("the σ march takes an unconditioned no-skip "
                         "σ-only net")
    return net


def hoist_rays(net: PackedNet, rays_o, rays_d):
    """→ oF, dF (R, 6L) phase intercept (π/2 folded) / slope; oWx, dWx
    (R, W) first-layer x intercept (bias folded) / slope; all f32."""
    fmat, off = phase_consts(net.L, rays_o.device)
    oF = rays_o.repeat(1, 2 * net.L) * fmat + off
    dF = rays_d.repeat(1, 2 * net.L) * fmat
    Wx, b0 = net.x_kernels[0]
    return oF, dF, rays_o @ Wx + b0, rays_d @ Wx


def _density(sigma, softplus: bool):
    return F.softplus(sigma) if softplus else torch.relu(sigma)


def _march_operand(net: PackedNet, oF, dF, t):
    """Posenc operand of rows (ray-major, t (m, S)) → (m·S, k0)."""
    P = oF[:, None, :] + dF[:, None, :] * t[..., None]
    a0 = _bf(torch.sin(P)).reshape(-1, P.shape[-1])
    return F.pad(a0, (0, net.k0 - a0.shape[1]))


def sigma_march_plain(net: PackedNet, hoists, alive, t, d,
                      softplus: bool = False):
    """Plain version of K1. alive (R,) f32; t, d (R, SB) f32.
    → w (R, SB), acc (R,), logT (R,)."""
    oF, dF, oWx, dWx = hoists
    R, SB = d.shape
    rpt = K.TILE_ROWS // SB
    w = torch.zeros_like(d)
    acc = torch.zeros((R,), dtype=d.dtype, device=d.device)
    logT = torch.zeros_like(acc)
    live = (alive.view(R // rpt, rpt) > 0).any(dim=1)
    idx = live.repeat_interleave(rpt).nonzero().squeeze(1)
    if idx.numel() == 0:
        return w, acc, logT
    tt = t[idx]
    a0 = _march_operand(net, oF[idx], dF[idx], tt)
    accx = (oWx[idx][:, None, :] + dWx[idx][:, None, :] * tt[..., None]
            ).reshape(-1, net.width)
    _, sigma = mlp_rows(net, a0, xterm=lambda _l: accx)
    x = _density(sigma.view(-1, SB), softplus) * d[idx]
    csum = torch.cumsum(torch.clamp(-x, min=_LOG_FLOOR), dim=1)
    excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    wl = (1.0 - torch.exp(-x)) * torch.exp(excl)
    w[idx] = wl
    acc[idx] = wl.sum(dim=1)
    logT[idx] = csum[:, -1]
    return w, acc, logT


def check_march_shape(R: int, SB: int, width: int, kernel_width: int,
                      tile_rows: int = K.TILE_ROWS):
    """Raise unless K1/K2 take R rays of SB samples a block and a net of
    this width: SB as the reference asserts it (`kernels.march_sb_ok`) and
    whole tiles of tile_rows // SB rays."""
    if width != kernel_width:
        raise ValueError(f"net width {width}: this march kernel is built "
                         f"for width {kernel_width}")
    if not K.march_sb_ok(SB, tile_rows):
        raise ValueError(f"SB={SB}: the march kernels take SB in "
                         f"{K.MARCH_SB} with (tile_rows // SB) % 4 == 0 "
                         f"(tile_rows {tile_rows})")
    rpt = tile_rows // SB
    if R % rpt:
        raise ValueError(f"R={R} must be a multiple of {rpt}")


def check_shapes(net: PackedNet, R: int, SB: int) -> None:
    """Raise unless the kernel `sigma_kernel` names takes the σ march of
    R rays of SB samples on `net` (K2 at its padded width)."""
    if sigma_kernel(net) == "K1":
        check_march_shape(R, SB, net.width, K.SIGMA_WIDTH)
    else:
        from fashion_nerf_torch.kernels import slimmarch
        slimmarch.check_shapes(net, R, SB)


def sigma_kernel(net: PackedNet) -> str:
    """The kernel the σ march of `net` takes on the card: "K1" at K1's
    width, else "K2" (without a view branch, zero-padded to its nearest
    width)."""
    return "K1" if net.width == K.SIGMA_WIDTH else "K2"


def sigma_march(net: PackedNet, hoists, alive, t, d, softplus: bool = False):
    """σ-only march: CPU tensors take the plain version, CUDA tensors K1
    (one launch per MARCH_MAX_TILES tiles), or K2 at a width K1 does not
    take (`sigma_kernel`; its launches count under "sigma_march_k2")."""
    oF, dF, oWx, dWx = hoists
    dev = K.on_cuda(alive, t, d, net.w, *hoists)
    if dev is None:
        return sigma_march_plain(net, hoists, alive, t, d, softplus)
    R, SB = d.shape
    W, nph = net.width, 6 * net.L
    for name, x, shape in (("alive", alive, (R,)), ("oWx", oWx, (R, W)),
                           ("dWx", dWx, (R, W)), ("oF", oF, (R, nph)),
                           ("dF", dF, (R, nph)), ("t", t, (R, SB)),
                           ("d", d, (R, SB))):
        K.check(x, name, torch.float32, shape)
    check_shapes(net, R, SB)
    if sigma_kernel(net) == "K2":
        from fashion_nerf_torch.kernels import slimmarch
        # one block: the tile of rays lives iff one of its rays is alive
        # (logT starts at 0 > log ε); a dead tile gives w = 0, logT = 0
        ones = torch.ones((R, 1), dtype=torch.float32, device=dev)
        _, w, logT = slimmarch.slim_march(
            net, hoists, None, alive, ones, t, d, -math.inf, softplus,
            count="sigma_march_k2")
        return w, w.sum(dim=1), logT
    wp = march_buffer(net)
    w = torch.empty_like(d)
    acc = torch.empty((R,), dtype=torch.float32, device=dev)
    logT = torch.empty_like(acc)
    lib = K.library()
    for rays in K.tile_ranges(R, K.TILE_ROWS // SB):
        r0 = rays.start
        ptrs = [K.row_ptr(x, r0) for x in (alive, oWx, dWx, oF, dF, t, d)]
        ptrs += [net.w.data_ptr(), wp.data_ptr(), net.b.data_ptr()]
        ptrs += [K.row_ptr(x, r0) for x in (w, acc, logT)]
        code = lib.fnt_sigma_march(
            *ptrs, rays.stop - rays.start, SB, net.L, net.depth, net.width,
            net.k0, int(softplus), wp.numel(), *K.launch_args(dev))
        K.raise_on_error(code, "fnt_sigma_march")
        K.LAUNCHES[K.march_count("sigma_march", SB)] += 1
    return w, acc, logT
