"""Generic carry march of a full field (kernel K6, csrc/carrymarch.cu).

Counterpart of `fashion_nerf.kernels.blockmarch_pallas` (`_carry_kernel`,
`_carry_eval`), the march the reference runs under
`kernels.carry_hoist=false`. A field packed as the fused field packs it
(`pack_params(model, hoist_x=False)`: the x rows stay in the posenc
operand) marches NB blocks of SB samples per ray with a log-transmittance
carry and rgb, depth and acc accumulators. Unlike K2 nothing is hoisted
but the per-ray view term: each sample's position o + d·t (f32, no fused
multiply-add) is built where the field is evaluated, and the operand is
[bf16(x) | bf16(sin P)].

The kernel is the fused field's forward (`wgf::forward`, the wgmma layer
loop of K3) inside the fine march's skeleton: widths 128 and 256, depth
2-8, a posenc operand of 48 or 64 columns, SB in MARCH_SB; narrower nets
run zero-padded.

A conditioned net takes its per-ray condpart (R, n_cond·W) bf16
(`posenc_mlp.hoist_cond`), the reference's cond window: slice i is added
in f32 to the i-th conditioned layer's accumulator before its bias.

Predication is per (tile, block), tile = net.tile_rows // SB rays (halved
for a conditioned net): the pair runs iff some ray of the tile has hit ∧
block_hit[b] ∧ logT > log ε, and then every ray of the tile is marched. A
dead pair writes w = 0 and leaves rgb, depth, acc and logT as they are.
White background is added by the caller.
"""

from __future__ import annotations

import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels.posenc_mlp import (PackedNet, check_condpart,
                                                   field_operand, kernel_net,
                                                   mlp_rows, pad_condpart,
                                                   pad_dirpart, per_row)
from fashion_nerf_torch.kernels.slimmarch import block_weights, live_rows
from fashion_nerf_torch.kernels.wgpack import field_buffer
from fashion_nerf_torch.trace import span

_BF = torch.bfloat16


def carry_march_plain(net: PackedNet, dirpart, rays_o, rays_d, hit,
                      block_hit, t, d, log_eps: float,
                      softplus: bool = False, condpart=None):
    """Plain version of K6. hit (R,), block_hit (R, NB), rays_o and rays_d
    (R, 3), t and d (R, NB·SB) f32, dirpart (R, W/2) bf16, condpart (R,
    n_cond·W) bf16 or None. → rgb (R, 3), depth (R,), acc (R,), w (R,
    NB·SB), logT (R,)."""
    R, S = t.shape
    NB = block_hit.shape[1]
    SB = S // NB
    rpt = net.tile_rows // SB
    dev = t.device
    rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((R,), dtype=torch.float32, device=dev)
    acc = torch.zeros_like(depth)
    w = torch.zeros_like(t)
    logT = torch.zeros_like(depth)
    for b in range(NB):
        cols = slice(b * SB, (b + 1) * SB)
        idx = live_rows(hit, block_hit[:, b], logT, rpt, log_eps)
        if idx.numel() == 0:
            continue
        tt = t[idx, cols]
        # o + d·t as two roundings, as the kernel builds it
        pts = (rays_o[idx][:, None, :]
               + rays_d[idx][:, None, :] * tt[..., None])
        a0 = field_operand(pts.reshape(-1, 3), net.L, net.k0)
        dir_rows = per_row(dirpart[idx], SB) if net.has_vd else None
        cond_rows = None if condpart is None else per_row(condpart[idx], SB)
        rgb_s, sigma = mlp_rows(net, a0, dir_rows=dir_rows,
                                cond_rows=cond_rows)
        wb, logT[idx] = block_weights(sigma.view(-1, SB), d[idx, cols],
                                      logT[idx], softplus)
        w[idx, cols] = wb
        rgb[idx] += (wb[..., None] * rgb_s.view(-1, SB, 3)).sum(dim=1)
        depth[idx] += (wb * tt).sum(dim=1)
        acc[idx] += wb.sum(dim=1)
    return rgb, depth, acc, w, logT


def check_shapes(net: PackedNet, R: int, SB: int) -> None:
    """Raise unless K6 takes R rays of SB-sample blocks on `net` (padded
    to the nearest net it is built for, `posenc_mlp.kernel_net`)."""
    if not K.march_sb_ok(SB, net.tile_rows):
        raise ValueError(f"SB={SB}: the carry march takes SB in MARCH_SB = "
                         f"{K.MARCH_SB} with (tile_rows // SB) % 4 == 0 "
                         f"(tile_rows {net.tile_rows})")
    if R % (net.tile_rows // SB):
        raise ValueError(f"R={R} must be a multiple of "
                         f"{net.tile_rows // SB}")
    kernel_net(net)


def carry_march(net: PackedNet, dirpart, rays_o, rays_d, hit, block_hit, t,
                d, log_eps: float, softplus: bool = False, condpart=None):
    """Generic carry march: CPU tensors take the plain version, CUDA
    tensors K6, one launch per sample block and per MARCH_MAX_TILES tiles
    of rays. SB as `kernels.march_sb_ok` takes it; a conditioned net takes
    its condpart.
    A net narrower than the kernel's widths runs padded with zeros
    (`posenc_mlp.pad_packed`): the same function at the padded net's cost."""
    dev = K.on_cuda(dirpart, rays_o, rays_d, hit, block_hit, t, d, net.w,
                    condpart)
    if dev is None:
        return carry_march_plain(net, dirpart, rays_o, rays_d, hit,
                                 block_hit, t, d, log_eps, softplus,
                                 condpart)
    with span("fnt.kernel.carry_march"):
        if not net.x_rows:
            raise ValueError("carry_march needs a net packed with "
                             "hoist_x=False")
        R, S = t.shape
        NB = block_hit.shape[1]
        SB = S // NB
        if S != NB * SB:
            raise ValueError(f"S={S} is not NB={NB} blocks")
        check_shapes(net, R, SB)
        tile_rows = net.tile_rows
        rpt = tile_rows // SB
        for name, x, shape in (("hit", hit, (R,)), ("block_hit", block_hit,
                                                    (R, NB)),
                               ("rays_o", rays_o, (R, 3)),
                               ("rays_d", rays_d, (R, 3)),
                               ("t", t, (R, S)), ("d", d, (R, S))):
            K.check(x, name, torch.float32, shape)
        K.check(dirpart, "dirpart", _BF, (R, dirpart.shape[1]))
        check_condpart(net, condpart, R)
        if net.has_vd and dirpart.shape[1] != net.width // 2:
            raise ValueError(f"dirpart width {dirpart.shape[1]}")
        knet = kernel_net(net)
        dirpart = pad_dirpart(net, knet, dirpart)
        condpart = pad_condpart(net, knet.width, condpart)
        cw = 0 if condpart is None else condpart.shape[1]
        wp = field_buffer(knet)
        rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
        depth = torch.empty((R,), dtype=torch.float32, device=dev)
        acc = torch.empty_like(depth)
        w = torch.empty_like(t)
        carry = [torch.empty_like(depth) for _ in range(2)]
        lib = K.library()
        for b in range(NB):
            for rays in K.tile_ranges(R, rpt):
                r0 = rays.start
                ptrs = [K.row_ptr(x, r0) for x in (
                    hit, block_hit, rays_o, rays_d, dirpart, t, d)]
                ptrs += [knet.w.data_ptr(), wp.data_ptr(), knet.b.data_ptr()]
                ptrs += [K.row_ptr(x, r0) for x in (
                    rgb, depth, acc, w, carry[b % 2], carry[(b + 1) % 2])]
                code = lib.fnt_carry_march(
                    *ptrs, K.row_ptr(condpart, r0) if cw else None, cw,
                    rays.stop - r0, NB, SB, b, knet.L, knet.depth, knet.width,
                    knet.k0, knet.skip_mask, int(knet.has_vd), int(softplus),
                    tile_rows, float(log_eps), *K.launch_args(dev))
                K.raise_on_error(code, "fnt_carry_march")
                K.LAUNCHES[K.march_count(
                    "carry_march_cond" if cw else "carry_march", SB)] += 1
        return rgb, depth, acc, w, carry[NB % 2]
