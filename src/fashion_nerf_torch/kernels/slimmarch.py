"""Multi-block march (kernel K2, csrc/slimmarch.cu): the 8×256 fine field,
and nets without a view branch.

Counterpart of `fashion_nerf.kernels.slimmarch_pallas` (`split_hoist`,
`hoist_rays`, `_slim_kernel`). The field marches NB blocks of SB samples
per ray with a log-transmittance carry and an rgb accumulator. The posenc
phases and the x-paths of the layers that take positions (the first, and
every skip layer) are linear in t and hoisted per ray, as the reference
hoists every x-consuming layer; the view term γ(d̂)·W_dir is per ray. A
net without a view branch (the reference's has_vd=False plans: the σ-only
proposal nets, no skip layer, of the generic proposal march and of the σ
march at a width K1 does not take) takes the 4-wide out head and no
dirpart. The kernel takes widths 128 and 256 with and without a view
branch (kernels.SLIM_WIDTHS); a narrower net, or one between them, runs
zero-padded to the nearest (`march_net`).

A conditioned net's cond enters folded into the x-intercepts oX (its rows
attach to exactly the x-layers and act on per-ray data), so the kernel has
no cond window.

Predication is per (tile, block), tile = net.tile_rows // SB rays (64 at
SB=32, 32 for a conditioned net): the pair runs iff some ray of the tile
has hit ∧ block_hit[b] ∧ logT > log ε, and then every ray of the tile is
marched. A dead pair writes w = 0 and leaves rgb and logT as they are.
White background is added by the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels.posenc_mlp import (PackedNet, mlp_rows,
                                                   pack_params, pad_dirpart,
                                                   pad_packed, phase_consts)
from fashion_nerf_torch.kernels.sigmamarch import (_LOG_FLOOR, _density,
                                                   _march_operand,
                                                   check_march_shape)
from fashion_nerf_torch.kernels.wgpack import march_buffer
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP

_BF = torch.bfloat16


def split_hoist(model: NeRFMLP) -> PackedNet:
    """Pack a net for K2 with its x-layers hoisted (net.x_kernels)."""
    return pack_params(model, hoist_x=True)


def hoist_rays(net: PackedNet, rays_o, rays_d, condpart=None):
    """→ oF, dF (R, 6L) phase intercept / slope; oX, dX (R, n_x·W) x-layer
    intercepts (bias folded, then the f32 of condpart's slice i for a
    conditioned net) / slopes, x-layer i in columns [i·W, (i+1)·W)."""
    fmat, off = phase_consts(net.L, rays_o.device)
    oF = rays_o.repeat(1, 2 * net.L) * fmat + off
    dF = rays_d.repeat(1, 2 * net.L) * fmat
    W, oXs = net.width, []
    for i, (Wx, b) in enumerate(net.x_kernels):
        o = rays_o @ Wx + b
        if condpart is not None:
            # the cond rows attach to exactly the x-layers, per ray
            o = o + condpart[:, i * W:(i + 1) * W].float()
        oXs.append(o)
    oX = torch.cat(oXs, dim=1)
    dX = torch.cat([rays_d @ Wx for Wx, _ in net.x_kernels], dim=1)
    return oF, dF, oX, dX


def live_rows(hit, block_hit_b, logT, rpt: int, log_eps: float):
    """Rays marched at one sample block: every ray of each tile of rpt rays
    in which some ray has hit ∧ block_hit ∧ logT > log ε (index tensor)."""
    ray_alive = (hit > 0) & (block_hit_b > 0) & (logT > log_eps)
    live = ray_alive.view(-1, rpt).any(dim=1)
    return live.repeat_interleave(rpt).nonzero().squeeze(1)


def block_weights(sigma, d, lt, softplus: bool):
    """One block's weights and carry: σ and d (m, SB), the carry lt (m,)
    before the block → (w (m, SB), carry after the block (m,)); the
    exclusive log-T prefix is an f32 sum of log(1 − α) clamped at
    log(1e-10) per sample."""
    x = _density(sigma, softplus) * d
    csum = torch.cumsum(torch.clamp(-x, min=_LOG_FLOOR), dim=1)
    excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1)
    return (1.0 - torch.exp(-x)) * torch.exp(lt[:, None] + excl), \
        lt + csum[:, -1]


def slim_march_plain(net: PackedNet, hoists, dirpart, hit, block_hit, t, d,
                     log_eps: float, softplus: bool = False):
    """Plain version of K2. hit (R,), block_hit (R, NB), t and d (R, NB·SB)
    f32, dirpart (R, W/2) bf16 (None for a net without a view branch).
    → rgb (R, 3), w (R, NB·SB), logT (R,)."""
    oF, dF, oX, dX = hoists
    R, S = t.shape
    NB = block_hit.shape[1]
    SB = S // NB
    rpt = net.tile_rows // SB
    W = net.width
    rgb = torch.zeros((R, 3), dtype=torch.float32, device=t.device)
    w = torch.zeros_like(t)
    logT = torch.zeros((R,), dtype=torch.float32, device=t.device)
    for b in range(NB):
        cols = slice(b * SB, (b + 1) * SB)
        idx = live_rows(hit, block_hit[:, b], logT, rpt, log_eps)
        if idx.numel() == 0:
            continue
        tt = t[idx, cols]
        a0 = _march_operand(net, oF[idx], dF[idx], tt)

        def xterm(l, tt=tt, idx=idx):
            sl = slice(l * W, (l + 1) * W)
            return (oX[idx, sl][:, None, :]
                    + dX[idx, sl][:, None, :] * tt[..., None]).reshape(-1, W)

        dir_rows = (dirpart[idx].float().repeat_interleave(SB, dim=0)
                    if net.has_vd else None)
        rgb_s, sigma = mlp_rows(net, a0, xterm=xterm, dir_rows=dir_rows)
        wb, logT[idx] = block_weights(sigma.view(-1, SB), d[idx, cols],
                                      logT[idx], softplus)
        w[idx, cols] = wb
        rgb[idx] += (wb[..., None] * rgb_s.view(-1, SB, 3)).sum(dim=1)
    return rgb, w, logT


def kernel_width(width: int) -> int:
    """The width of K2's instantiation a net of this width runs at: the
    nearest of kernels.SLIM_WIDTHS at or above it. Raises above 256."""
    wide = [w for w in K.SLIM_WIDTHS if w >= width]
    if width < 1 or not wide:
        raise ValueError(f"net width {width}: K2 takes widths "
                         f"{K.SLIM_WIDTHS}, narrower nets padded")
    return wide[0]


def march_net(net: PackedNet) -> PackedNet:
    """`net` itself at a width K2 is built for, else its zero-padded
    version (`posenc_mlp.pad_packed`), built on first use and kept on the
    net."""
    width = kernel_width(net.width)
    if width == net.width:
        return net
    if net.padded is None:
        net.padded = pad_packed(net, width)
    return net.padded


def pad_hoists(net: PackedNet, knet: PackedNet, hoists):
    """The per-ray hoists of `net` widened to its padded net `knet`: each
    x-layer's W columns of oX and dX get zero columns."""
    oF, dF, oX, dX = hoists
    if knet is net:
        return hoists
    R, pad = oX.shape[0], (0, knet.width - net.width)
    return (oF, dF) + tuple(
        F.pad(x.reshape(R, -1, net.width), pad).reshape(R, -1).contiguous()
        for x in (oX, dX))


def check_shapes(net: PackedNet, R: int, SB: int) -> None:
    """Raise unless K2 takes R rays of SB-sample blocks on `net` at the
    width it runs it (`march_net`)."""
    width = kernel_width(net.width)
    check_march_shape(R, SB, width, width, net.tile_rows)


def slim_march(net: PackedNet, hoists, dirpart, hit, block_hit, t, d,
               log_eps: float, softplus: bool = False, count: str = None):
    """Multi-block march: CPU tensors take the plain version, CUDA tensors
    K2 (one launch per sample block and per MARCH_MAX_TILES tiles). A net without a view branch takes
    dirpart None. A net of a width K2 is not built for runs zero-padded
    (`march_net`). count: the LAUNCHES entry the launches go to (default:
    by the net's kind)."""
    oF, dF, oX, dX = hoists
    if (dirpart is None) == net.has_vd:
        raise ValueError("a net with a view branch takes a dirpart, and "
                         "only it")
    dev = K.on_cuda(dirpart, hit, block_hit, t, d, net.w, *hoists)
    if dev is None:
        return slim_march_plain(net, hoists, dirpart, hit, block_hit, t, d,
                                log_eps, softplus)
    R, S = t.shape
    NB = block_hit.shape[1]
    SB = S // NB
    W, nph = net.width, 6 * net.L
    nx = len(net.x_kernels)
    if S != NB * SB:
        raise ValueError(f"S={S} is not NB={NB} blocks")
    check_shapes(net, R, SB)
    knet = march_net(net)
    for name, x, shape in (("hit", hit, (R,)), ("block_hit", block_hit,
                                                (R, NB)),
                           ("oX", oX, (R, nx * W)), ("dX", dX, (R, nx * W)),
                           ("oF", oF, (R, nph)), ("dF", dF, (R, nph)),
                           ("t", t, (R, S)), ("d", d, (R, S))):
        K.check(x, name, torch.float32, shape)
    if net.has_vd:
        K.check(dirpart, "dirpart", _BF, (R, W // 2))
        dirpart = pad_dirpart(net, knet, dirpart)
    oF, dF, oX, dX = pad_hoists(net, knet, hoists)
    wp = march_buffer(knet)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    w = torch.empty_like(t)
    carry = [torch.empty((R,), dtype=torch.float32, device=dev)
             for _ in range(2)]
    lib = K.library()
    count = K.march_count(count or (
        "slim_march_cond" if net.n_cond else
        "slim_march" if net.has_vd else "slim_march_novd"), SB)
    ranges = K.tile_ranges(R, net.tile_rows // SB)
    for b in range(NB):
        for rays in ranges:
            r0 = rays.start
            ptrs = [K.row_ptr(x, r0) for x in (
                hit, block_hit, oX, dX, oF, dF, dirpart, t, d)]
            ptrs += [knet.w.data_ptr(), wp.data_ptr(), knet.b.data_ptr()]
            ptrs += [K.row_ptr(x, r0) for x in (
                rgb, w, carry[b % 2], carry[(b + 1) % 2])]
            code = lib.fnt_slim_march(
                *ptrs, rays.stop - rays.start, NB, SB, b, knet.L, knet.depth,
                knet.width, knet.k0, knet.skip_mask, int(knet.has_vd),
                int(softplus), net.tile_rows, float(log_eps),
                *K.launch_args(dev))
            K.raise_on_error(code, "fnt_slim_march")
            K.LAUNCHES[count] += 1
    return rgb, w, carry[NB % 2]
