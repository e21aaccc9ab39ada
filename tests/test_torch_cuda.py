"""The port's CUDA kernels against their plain versions on the card, at
small shapes and edge cases (all-dead launches, culled rays in live tiles,
rejected inputs). Marked `cuda`: skipped where no CUDA device is present.

This file imports no JAX, so it also runs on a GPU host without JAX:
    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
(`--noconftest` skips tests/conftest.py, which imports JAX.)"""

import contextlib
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels import (carrymarch, posenc_mlp, sigmamarch,
                                        slimmarch)
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _net(rng, shapes):
    return load_flax_params({"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32),
            "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
        for name, (i, o) in shapes.items()}}, compute_dtype="bfloat16")


def fine_net(rng, W=256, L=10):
    """Flagship-shaped random field: 8×256, skip after layer 4."""
    cx, cd = 3 * (2 * L + 1), 27
    shapes = {f"trunk_{i}": ((cx + W) if i == 5 else (cx if i == 0 else W),
                             W) for i in range(8)}
    shapes.update(sigma_head=(W, 1), feature=(W, W), view_0=(W + cd, W // 2),
                  rgb_head=(W // 2, 3))
    return _net(rng, shapes)


def prop_net(rng, W=128, L=6):
    return _net(rng, {"trunk_0": (3 * (2 * L + 1), W), "trunk_1": (W, W),
                      "out_head": (W, 4)})


def noview_net(rng, W=256, L=6):
    """4×W without a view branch, the skip after layer 1."""
    cx = 3 * (2 * L + 1)
    return _net(rng, {"trunk_0": (cx, W), "trunk_1": (W, W),
                      "trunk_2": (cx + W, W), "trunk_3": (W, W),
                      "out_head": (W, 4)})


def small_net(rng, W, depth, L, vd, skip=None):
    """A net below the kernels' widths: `depth` layers of width W, layer
    `skip` taking the skip, with or without the view branch."""
    cx = 3 * (2 * L + 1)
    shapes = {f"trunk_{i}": ((cx + W) if i == skip else (cx if i == 0 else W),
                             W) for i in range(depth)}
    if vd:
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
    else:
        shapes["out_head"] = (W, 4)
    return _net(rng, shapes)


FIELD_NETS = {"fine": fine_net, "prop": prop_net, "noview": noview_net,
              "w32": lambda rng: small_net(rng, 32, 3, 4, True),
              "w64": lambda rng: small_net(rng, 64, 4, 6, True, skip=2),
              "w16": lambda rng: small_net(rng, 16, 3, 2, False),
              "w64nv": lambda rng: small_net(rng, 64, 3, 4, False)}


def _f32(rng, *shape, lo=-1.0, hi=1.0, dev=None):
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                        device=dev)


def _rays(R, dev):
    ro = torch.zeros((R, 3), device=dev)
    ro[:, 2] = 4.0
    ang = torch.linspace(-0.4, 0.4, R, device=dev)
    rd = torch.stack([torch.sin(ang), 0.1 * torch.cos(3 * ang),
                      -torch.cos(ang)], dim=-1)
    return ro, rd


def _close(a, b, atol):
    assert float((a - b).abs().max()) <= atol


@pytest.mark.parametrize("which,n,spr", [
    ("fine", 4096, 64), ("fine", 4160, 64), ("fine", 1088, 1),
    ("fine", 3072, 192), ("prop", 4160, 64), ("prop", 1088, 1),
    ("noview", 4096, 64), ("noview", 1088, 1)])
def test_field_kernel(dev, which, n, spr):
    """Random nets of widths 256 and 128, L = 10 and 6, with and without the
    view branch, whole and half (n ≡ 64 mod 128) work items: rgb atol
    5e-3, σ within 2e-2·(1+|σ|), every row."""
    rng = np.random.default_rng(0)
    net = posenc_mlp.pack_params(FIELD_NETS[which](rng).to(dev),
                                 hoist_x=False)
    pts = _f32(rng, n, 3, lo=-1.2, hi=1.2, dev=dev)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, n // spr, 3,
                                         dev=dev)).contiguous()
    n0 = K.LAUNCHES["field"]
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, spr)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, spr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["field"] == n0 + 1
    assert rgb_k.shape == (n, 3) and sig_k.shape == (n,)
    _close(rgb_k, rgb_p, 5e-3)
    assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())


def test_field_kernels_reject_width_64(dev):
    """Nets of width 64 and 32 (depth 3, L = 4) no longer raise: K3 and K4
    run them zero-padded and match the plain versions on the unpadded net
    (K3 5e-3 on every row, K4 1e-2 relative RMS, gradients in the unpadded
    layout). The refusals that remain raise ValueError: width 512, depth
    9, L = 12."""
    rng = np.random.default_rng(8)
    for W in (64, 32):
        net = posenc_mlp.pack_params(small_net(rng, W, 3, 4, True).to(dev),
                                     hoist_x=False)
        args = _bwd_inputs(rng, net, 128, 64, dev)
        n0 = dict(K.LAUNCHES)
        rgb_k, sig_k = posenc_mlp.field_rows(net, args[0], args[1], 64)
        rgb_p, sig_p = posenc_mlp.field_rows_plain(net, args[0], args[1], 64)
        out_k = posenc_mlp.field_rows_backward(net, *args, 64)
        out_p = posenc_mlp.field_rows_backward_plain(net, *args, 64)
        assert K.LAUNCHES["field"] == n0["field"] + 1
        assert K.LAUNCHES["field_bwd"] == n0["field_bwd"] + 1
        _close(rgb_k, rgb_p, 5e-3)
        assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())
        for a, b in zip(out_k, out_p):
            assert a.shape == b.shape and _rel_rms(a, b) <= 1e-2
    pts = _f32(rng, 128, 3, dev=dev)
    g3, g1 = _f32(rng, 128, 3, dev=dev), _f32(rng, 128, dev=dev)
    for model, match in ((small_net(rng, 512, 3, 4, True), "width"),
                         (small_net(rng, 64, 9, 4, True), "depth"),
                         (small_net(rng, 64, 3, 12, True), "posenc")):
        net = posenc_mlp.pack_params(model.to(dev), hoist_x=False)
        dp = torch.zeros((2, net.width // 2), dtype=torch.bfloat16,
                         device=dev)
        with pytest.raises(ValueError, match=match):
            posenc_mlp.field_rows(net, pts, dp, 64)
        with pytest.raises(ValueError, match=match):
            posenc_mlp.field_rows_backward(net, pts, dp, g3, g1, 64)


@pytest.mark.parametrize("which,n,spr", [
    ("w32", 4160, 64), ("w32", 1088, 1), ("w64", 3072, 192),
    ("w64", 4096, 64), ("w16", 2048, 64), ("w64nv", 1088, 1)])
def test_field_kernels_padded_nets(dev, which, n, spr):
    """Widths 16, 32 and 64, L = 2, 4 and 6, depth 3 and 4, with a skip
    layer, with and without the view branch: K3 and K4 on the zero-padded
    net against the plain versions on the unpadded net. K3: rgb 5e-3 and σ
    2e-2·(1+|σ|) on every row. K4: 1e-2 relative RMS per tensor, in the
    unpadded layout, bitwise the same over two runs."""
    rng = np.random.default_rng(9)
    net = posenc_mlp.pack_params(FIELD_NETS[which](rng).to(dev),
                                 hoist_x=False)
    args = _bwd_inputs(rng, net, n, spr, dev)
    n0 = dict(K.LAUNCHES)
    rgb_k, sig_k = posenc_mlp.field_rows(net, args[0], args[1], spr)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, args[0], args[1], spr)
    out_k = posenc_mlp.field_rows_backward(net, *args, spr)
    out_k2 = posenc_mlp.field_rows_backward(net, *args, spr)
    out_p = posenc_mlp.field_rows_backward_plain(net, *args, spr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["field"] == n0["field"] + 1
    assert K.LAUNCHES["field_bwd"] == n0["field_bwd"] + 2
    assert net.padded is not None and net.padded.width == 128
    _close(rgb_k, rgb_p, 5e-3)
    assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())
    for name, a, a2, b in zip(("d_pts", "d_dir", "d_w", "d_b"), out_k,
                              out_k2, out_p):
        assert a.shape == b.shape, name
        assert torch.equal(a, a2), name
        if name == "d_dir" and not net.has_vd:
            assert bool((a == 0).all())
            continue
        assert _rel_rms(a, b) <= 1e-2, (name, _rel_rms(a, b))


@pytest.mark.parametrize("case", ["mixed", "all_dead"])
def test_sigma_march_kernel(dev, case):
    """w/acc atol 2e-3; dead tiles exact zeros; a culled ray in a live tile
    is marched."""
    rng = np.random.default_rng(1)
    R, SB = 128, 64
    net = sigmamarch.pack_sigma(prop_net(rng).to(dev))
    ro, rd = _rays(R, dev)
    hz = sigmamarch.hoist_rays(net, ro, rd)
    t = torch.linspace(2.0, 6.0, SB, device=dev).expand(R, SB).contiguous()
    d = torch.full((R, SB), 4.0 / SB, device=dev)
    alive = torch.ones(R, device=dev)
    alive[:32] = 0.0                  # tile 0 dead
    alive[40] = 0.0                   # culled ray in live tile 1
    if case == "all_dead":
        alive.zero_()
    w_k, acc_k, lt_k = sigmamarch.sigma_march(net, hz, alive, t, d)
    w_p, acc_p, lt_p = sigmamarch.sigma_march_plain(net, hz, alive, t, d)
    _close(w_k, w_p, 2e-3)
    _close(acc_k, acc_p, 2e-3)
    _close(lt_k.exp(), lt_p.exp(), 2e-3)
    assert bool((w_k[:32] == 0).all() and (acc_k[:32] == 0).all())
    if case == "mixed":
        assert float(acc_k[40]) > 0.0


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_slim_march_kernel(dev, eps):
    """rgb/w atol 5e-3 with dead (tile, block) pairs from block flags, a
    dead tile, a culled ray in a live tile, and (ε = 1e-3) termination."""
    rng = np.random.default_rng(2)
    R, NB, SB = 192, 3, 32
    net = slimmarch.split_hoist(fine_net(rng).to(dev))
    ro, rd = _rays(R, dev)
    hf = slimmarch.hoist_rays(net, ro, rd)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    t = torch.linspace(2.0, 6.0, NB * SB, device=dev).expand(
        R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 4.0 / (NB * SB), device=dev)
    hit = torch.ones(R, device=dev)
    hit[:64] = 0.0                    # tile 0 dead
    hit[70] = 0.0                     # culled ray in live tile 1
    bhit = torch.ones((R, NB), device=dev)
    bhit[128:, 1] = 0.0               # tile 2, block 1 dead
    log_eps = math.log(eps) if eps > 0 else -1e30
    n0 = K.LAUNCHES["slim_march"]
    out_k = slimmarch.slim_march(net, hf, dp, hit, bhit, t, d, log_eps)
    out_p = slimmarch.slim_march_plain(net, hf, dp, hit, bhit, t, d, log_eps)
    assert K.LAUNCHES["slim_march"] == n0 + NB
    for a, b in zip(out_k[:2], out_p[:2]):
        _close(a, b, 5e-3)
    _close(out_k[2].exp(), out_p[2].exp(), 5e-3)     # transmittance
    w_k = out_k[1]
    assert bool((w_k[:64] == 0).all())
    assert bool((w_k[128:, SB:2 * SB] == 0).all())


def _executed(w, hit, bhit, eps):
    """Executed (tile, block) pairs reconstructed from the weights."""
    from fashion_nerf_torch.render.blockwise import march_liveness
    cfg = SimpleNamespace(kernels=SimpleNamespace(early_term_eps=eps))
    return march_liveness(w, hit, bhit, cfg)["tile_alive"]


def _march_case(rng, case, R, NB, SB, dev):
    """hit, block_hit, t, d of an edge case: all_dead (no alive ray),
    one_tile (one alive ray, in tile 3), terminated (dense rays that
    saturate), ragged (2% alive rays, 60% block flags, widths spread over
    100×: partial tiles whose live rows are few and scattered)."""
    S = NB * SB
    t = torch.linspace(2.0, 6.0, S, device=dev).expand(R, S).contiguous()
    d = torch.full((R, S), 4.0 / S, device=dev)
    hit = torch.ones(R, device=dev)
    bhit = torch.ones((R, NB), device=dev)
    if case == "all_dead":
        hit.zero_()
    elif case == "one_tile":
        hit.zero_()
        hit[3 * (K.TILE_ROWS // SB) + 17] = 1.0
    elif case == "terminated":
        d = d * _f32(rng, R, 1, lo=20.0, hi=200.0, dev=dev)
    elif case == "ragged":
        hit = torch.tensor(rng.random(R) < 0.02, dtype=torch.float32,
                           device=dev)
        bhit = torch.tensor(rng.random((R, NB)) < 0.6, dtype=torch.float32,
                            device=dev)
        d = d * _f32(rng, R, 1, lo=1.0, hi=100.0, dev=dev)
    return hit, bhit, t, d.contiguous()


@pytest.mark.parametrize("case,SB", [
    ("all_dead", 32), ("one_tile", 32), ("terminated", 32), ("ragged", 32),
    ("ragged", 16), ("terminated", 64)])
def test_slim_march_edge_cases(dev, case, SB):
    """K2 against its plain version on 6 tiles: rgb/w/transmittance atol
    5e-3 and identical executed (tile, block) pairs, for an all-dead launch,
    a single live tile, terminated rays and ragged live rows."""
    rng = np.random.default_rng(10)
    NB, eps = 3, 1e-3
    R = 6 * (K.TILE_ROWS // SB)
    net = slimmarch.split_hoist(fine_net(rng).to(dev))
    ro, rd = _rays(R, dev)
    hf = slimmarch.hoist_rays(net, ro, rd)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    hit, bhit, t, d = _march_case(rng, case, R, NB, SB, dev)
    args = (net, hf, dp, hit, bhit, t, d, math.log(eps))
    n0 = K.LAUNCHES["slim_march"]
    out_k = slimmarch.slim_march(*args)
    out_p = slimmarch.slim_march_plain(*args)
    assert K.LAUNCHES["slim_march"] == n0 + NB
    _close(out_k[0], out_p[0], 5e-3)
    _close(out_k[1], out_p[1], 5e-3)
    _close(out_k[2].exp(), out_p[2].exp(), 5e-3)
    live_k = _executed(out_k[1], hit, bhit, eps)
    live_p = _executed(out_p[1], hit, bhit, eps)
    assert torch.equal(live_k, live_p)
    n_exec = int(live_k.sum())
    if case == "all_dead":
        assert n_exec == 0 and bool((out_k[1] == 0).all())
        assert bool((out_k[0] == 0).all() and (out_k[2] == 0).all())
    elif case == "one_tile":
        assert n_exec == NB and bool(live_k[3].all())
    else:
        cand = (hit[:, None] * bhit).view(-1, K.TILE_ROWS // SB, NB)
        assert 0 < n_exec < int((cand.amax(dim=1) > 0).sum())
        assert int((out_p[2] < math.log(eps)).sum()) > 0


@pytest.mark.parametrize("case,SB", [
    ("all_dead", 64), ("one_tile", 64), ("ragged", 64), ("ragged", 32),
    ("ragged", 16)])
def test_sigma_march_edge_cases(dev, case, SB):
    """K1 against its plain version on 6 tiles: w/acc/transmittance atol
    2e-3; dead tiles exact zeros and live tiles marched whole."""
    rng = np.random.default_rng(11)
    R = 6 * (K.TILE_ROWS // SB)
    net = sigmamarch.pack_sigma(prop_net(rng).to(dev))
    ro, rd = _rays(R, dev)
    hz = sigmamarch.hoist_rays(net, ro, rd)
    alive, _, t, d = _march_case(rng, case, R, 1, SB, dev)
    n0 = K.LAUNCHES["sigma_march"]
    w_k, acc_k, lt_k = sigmamarch.sigma_march(net, hz, alive, t, d)
    w_p, acc_p, lt_p = sigmamarch.sigma_march_plain(net, hz, alive, t, d)
    assert K.LAUNCHES["sigma_march"] == n0 + 1
    _close(w_k, w_p, 2e-3)
    _close(acc_k, acc_p, 2e-3)
    _close(lt_k.exp(), lt_p.exp(), 2e-3)
    live = (alive.view(-1, K.TILE_ROWS // SB) > 0).any(dim=1)
    marched = (acc_k.view(-1, K.TILE_ROWS // SB) > 0).any(dim=1)
    assert torch.equal(live, marched)
    if case == "one_tile":
        assert int(live.sum()) == 1 and bool(live[3])


def _sb_case(rng, R, NB, SB, dev):
    """hit, block_hit, t, d over 8 tiles at any SB: 30% alive rays, 70%
    block flags, a width per ray in [0.01, 1.5] whatever the sample count
    (some rays terminate; a width of 100 or more would turn σ's bf16
    rounding, 2e-2·(1 + |σ|), into weights 1e-2 apart), and tile 1 dead."""
    S = NB * SB
    rpt = R // 8
    t = torch.linspace(2.0, 6.0, S, device=dev).expand(R, S).contiguous()
    d = _f32(rng, R, 1, lo=0.01, hi=1.5, dev=dev).expand(R, S).contiguous()
    hit = torch.tensor(rng.random(R) < 0.3, dtype=torch.float32, device=dev)
    hit[:rpt] = 1.0
    hit[rpt:2 * rpt] = 0.0
    bhit = torch.tensor(rng.random((R, NB)) < 0.7, dtype=torch.float32,
                        device=dev)
    bhit[:, 0] = 1.0
    return hit, bhit, t, d


@pytest.mark.parametrize("SB", [1, 8, 128, 256, 512])
def test_sigma_march_every_sb(dev, SB):
    """K1 at SBs outside 16–64 against its plain version on 8 tiles:
    w/acc/transmittance atol 2e-3, dead tiles exact zeros, live tiles
    marched whole; launches counted under "sigma_march_sb"."""
    rng = np.random.default_rng(15)
    R = 8 * (K.TILE_ROWS // SB)
    net = sigmamarch.pack_sigma(prop_net(rng).to(dev))
    ro, rd = _rays(R, dev)
    hz = sigmamarch.hoist_rays(net, ro, rd)
    alive, _, t, d = _sb_case(rng, R, 1, SB, dev)
    n0 = dict(K.LAUNCHES)
    w_k, acc_k, lt_k = sigmamarch.sigma_march(net, hz, alive, t, d)
    assert K.LAUNCHES["sigma_march_sb"] == n0["sigma_march_sb"] + 1
    assert K.LAUNCHES["sigma_march"] == n0["sigma_march"]
    w_p, acc_p, lt_p = sigmamarch.sigma_march_plain(net, hz, alive, t, d)
    _close(w_k, w_p, 2e-3)
    _close(acc_k, acc_p, 2e-3)
    _close(lt_k.exp(), lt_p.exp(), 2e-3)
    live = (alive.view(8, -1) > 0).any(dim=1)
    marched = (acc_k.view(8, -1) > 0).any(dim=1)
    assert torch.equal(live, marched) and not bool(live[1])


@pytest.mark.parametrize("which,SB,NB", [
    ("fine", 8, 4), ("fine", 128, 2), ("fine", 256, 2), ("fine", 512, 1),
    ("fine", 1, 3), ("noview", 8, 2), ("noview", 256, 1), ("w64", 128, 2),
    ("cond", 256, 2), ("cond", 8, 2)])
def test_slim_march_every_sb(dev, which, SB, NB):
    """K2 at SBs outside 16–64 (and a conditioned net at its halved tile,
    up to 256) against its plain version on 8 tiles: rgb/w/transmittance
    atol 5e-3 and identical executed (tile, block) pairs, with terminated
    rays; launches counted under "slim_march_sb"."""
    rng = np.random.default_rng(16)
    eps = 1e-3
    if which == "cond":
        # the flagship's layout with 16 cond rows in trunk_0 and trunk_5
        cx, W, cc = 63, 256, 16
        shapes = {f"trunk_{i}": ((cx + cc + W) if i == 5 else
                                 (cx + cc if i == 0 else W), W)
                  for i in range(8)}
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
        tree = {"params": {
            name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
                np.float32), "bias": (0.1 * rng.normal(size=o)).astype(
                    np.float32)} for name, (i, o) in shapes.items()}}
        model = load_flax_params(tree, compute_dtype="bfloat16",
                                 cond_dim=cc).to(dev)
    else:
        model = FIELD_NETS[which](rng).to(dev)
    net = slimmarch.split_hoist(model)
    R = 8 * (net.tile_rows // SB)
    ro, rd = _rays(R, dev)
    cp = None
    if which == "cond":
        assert net.tile_rows == K.TILE_ROWS // 2
        cp = posenc_mlp.hoist_cond(net, _f32(rng, R, 16, dev=dev))
    hf = slimmarch.hoist_rays(net, ro, rd, cp)
    dp = (posenc_mlp.hoist_dirs(net, rd).contiguous() if net.has_vd
          else None)
    hit, bhit, t, d = _sb_case(rng, R, NB, SB, dev)
    args = (net, hf, dp, hit, bhit, t, d, math.log(eps))
    n0 = dict(K.LAUNCHES)
    out_k = slimmarch.slim_march(*args)
    assert K.LAUNCHES["slim_march_sb"] == n0["slim_march_sb"] + NB
    out_p = slimmarch.slim_march_plain(*args)
    _close(out_k[0], out_p[0], 5e-3)
    _close(out_k[1], out_p[1], 5e-3)
    _close(out_k[2].exp(), out_p[2].exp(), 5e-3)
    rpt = net.tile_rows // SB
    cfg = SimpleNamespace(kernels=SimpleNamespace(early_term_eps=eps))
    from fashion_nerf_torch.render.blockwise import march_liveness
    live_k = march_liveness(out_k[1], hit, bhit, cfg,
                            net.tile_rows)["tile_alive"]
    live_p = march_liveness(out_p[1], hit, bhit, cfg,
                            net.tile_rows)["tile_alive"]
    assert torch.equal(live_k, live_p)
    assert 0 < int(live_k.sum()) and not bool(live_k[1].any())
    assert bool((out_k[1][rpt:2 * rpt] == 0).all())


@pytest.mark.parametrize("which,SB,NB", [
    ("fine", 8, 4), ("fine", 128, 2), ("fine", 256, 2), ("fine", 512, 1),
    ("fine", 2, 2), ("w64nv", 256, 1), ("w32", 8, 2)])
def test_carry_march_every_sb(dev, which, SB, NB):
    """K6 at SBs outside 16–64 against its plain version on 8 tiles:
    rgb/acc/w/transmittance atol 5e-3, depth 5e-3·far, identical executed
    (tile, block) pairs; launches counted under "carry_march_sb"."""
    rng = np.random.default_rng(17)
    eps, far = 1e-3, 6.0
    R = 8 * (K.TILE_ROWS // SB)
    net = posenc_mlp.pack_params(FIELD_NETS[which](rng).to(dev),
                                 hoist_x=False)
    ro, rd = _rays(R, dev)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    hit, bhit, t, d = _sb_case(rng, R, NB, SB, dev)
    args = (net, dp, ro, rd, hit, bhit, t, d, math.log(eps))
    n0 = dict(K.LAUNCHES)
    out_k = carrymarch.carry_march(*args)
    assert K.LAUNCHES["carry_march_sb"] == n0["carry_march_sb"] + NB
    out_p = carrymarch.carry_march_plain(*args)
    for name, a, b, tol in zip(("rgb", "depth", "acc", "w"), out_k, out_p,
                               (5e-3, 5e-3 * far, 5e-3, 5e-3)):
        assert float((a - b).abs().max()) <= tol, name
    _close(out_k[4].exp(), out_p[4].exp(), 5e-3)
    live_k = _executed(out_k[3], hit, bhit, eps)
    live_p = _executed(out_p[3], hit, bhit, eps)
    assert torch.equal(live_k, live_p)
    assert 0 < int(live_k.sum()) and not bool(live_k[1].any())


def test_march_wrappers_split_tiles(dev, monkeypatch):
    """K1 and K2 march more tiles than one launch takes in ranges of rays,
    with the same outputs as one launch."""
    rng = np.random.default_rng(18)
    SB, NB = 64, 2
    R = 6 * (K.TILE_ROWS // SB)
    pnet = sigmamarch.pack_sigma(prop_net(rng).to(dev))
    fnet = slimmarch.split_hoist(fine_net(rng).to(dev))
    ro, rd = _rays(R, dev)
    hit, bhit, t, d = _sb_case(rng, R, NB, SB, dev)
    a1 = (pnet, sigmamarch.hoist_rays(pnet, ro, rd), hit, t[:, :SB].contiguous(),
          d[:, :SB].contiguous())
    a2 = (fnet, slimmarch.hoist_rays(fnet, ro, rd),
          posenc_mlp.hoist_dirs(fnet, rd).contiguous(), hit, bhit, t, d,
          math.log(1e-3))
    whole = sigmamarch.sigma_march(*a1) + slimmarch.slim_march(*a2)
    monkeypatch.setattr(K, "MARCH_MAX_TILES", 4)
    n0 = dict(K.LAUNCHES)
    split = sigmamarch.sigma_march(*a1) + slimmarch.slim_march(*a2)
    assert K.LAUNCHES["sigma_march"] == n0["sigma_march"] + 2
    assert K.LAUNCHES["slim_march"] == n0["slim_march"] + 2 * NB
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


def test_march_wrappers_reject_bad_shapes(dev):
    """K1/K2 take the reference's SBs (not 24 or 1024), whole tiles and
    nets up to width 256
    (K2 pads narrower ones; the σ march takes K2 off K1's width 128); R = 0
    returns empty outputs without a launch."""
    rng = np.random.default_rng(12)
    fnet = slimmarch.split_hoist(fine_net(rng).to(dev))
    pnet = sigmamarch.pack_sigma(prop_net(rng).to(dev))

    def k2(net, R, NB, SB):
        ro, rd = _rays(R, dev)
        S = NB * SB
        return slimmarch.slim_march(
            net, slimmarch.hoist_rays(net, ro, rd),
            torch.zeros((R, net.width // 2), dtype=torch.bfloat16,
                        device=dev),
            torch.ones(R, device=dev), torch.ones((R, NB), device=dev),
            torch.ones((R, S), device=dev), torch.ones((R, S), device=dev),
            -6.9)

    def k1(net, R, SB):
        ro, rd = _rays(R, dev)
        return sigmamarch.sigma_march(
            net, sigmamarch.hoist_rays(net, ro, rd), torch.ones(R, device=dev),
            torch.ones((R, SB), device=dev), torch.ones((R, SB), device=dev))

    # widths K1 and K2 are not built for run padded (test_torch_skips'
    # cases); what no padding reaches still raises
    wide = sigmamarch.pack_sigma(prop_net(rng, W=320).to(dev))
    for call in (lambda: k2(fnet, 340, 2, 24), lambda: k2(fnet, 96, 2, 32),
                 lambda: k1(pnet, 64, 1024), lambda: k1(pnet, 48, 64),
                 lambda: k1(wide, 32, 64)):
        with pytest.raises(ValueError):
            call()
    n0 = dict(K.LAUNCHES)
    rgb, w, lt = k2(fnet, 0, 3, 32)
    assert rgb.shape == (0, 3) and w.shape == (0, 96) and lt.shape == (0,)
    w1, acc, _ = k1(pnet, 0, 64)
    assert w1.shape == (0, 64) and acc.shape == (0,)
    assert dict(K.LAUNCHES) == n0


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_carry_march_kernel(dev, eps):
    """K6: rgb/w/acc atol 5e-3 (depth 5e-3·far) with dead (tile, block)
    pairs from block flags, a dead tile, a culled ray in a live tile, and
    (ε = 1e-3) termination; and against K2 on the same rays within the
    reference's random-net bound 2e-3 · far (depth) / 5e-3 (the rest)."""
    rng = np.random.default_rng(8)
    R, NB, SB = 192, 3, 32
    model = fine_net(rng).to(dev)
    net = posenc_mlp.pack_params(model, hoist_x=False)
    ro, rd = _rays(R, dev)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    t = torch.linspace(2.0, 6.0, NB * SB, device=dev).expand(
        R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 4.0 / (NB * SB), device=dev)
    hit = torch.ones(R, device=dev)
    hit[:64] = 0.0                    # tile 0 dead
    hit[70] = 0.0                     # culled ray in live tile 1
    bhit = torch.ones((R, NB), device=dev)
    bhit[128:, 1] = 0.0               # tile 2, block 1 dead
    log_eps = math.log(eps) if eps > 0 else -1e30
    args = (net, dp, ro, rd, hit, bhit, t, d, log_eps)
    n0 = K.LAUNCHES["carry_march"]
    out_k = carrymarch.carry_march(*args)
    out_p = carrymarch.carry_march_plain(*args)
    assert K.LAUNCHES["carry_march"] == n0 + NB
    for name, a, b, tol in zip(("rgb", "depth", "acc", "w"), out_k, out_p,
                               (5e-3, 3e-2, 5e-3, 5e-3)):
        _close(a, b, tol)
    _close(out_k[4].exp(), out_p[4].exp(), 5e-3)     # transmittance
    w_k = out_k[3]
    assert bool((w_k[:64] == 0).all())
    assert bool((w_k[128:, SB:2 * SB] == 0).all())
    assert float(out_k[2][70]) > 0.0
    snet = slimmarch.split_hoist(model)
    rgb_s, w_s, _ = slimmarch.slim_march(
        snet, slimmarch.hoist_rays(snet, ro, rd), dp, hit, bhit, t, d,
        log_eps)
    _close(out_k[0], rgb_s, 5e-3)
    _close(out_k[3], w_s, 5e-3)
    with pytest.raises(ValueError):
        carrymarch.carry_march(snet, *args[1:])


@pytest.mark.parametrize("which,SB,case", [
    ("fine", 16, "ragged"), ("fine", 32, "ragged"), ("fine", 64, "ragged"),
    ("fine", 32, "all_dead"), ("fine", 32, "one_tile"),
    ("fine", 64, "terminated"), ("prop", 32, "ragged"),
    ("prop", 64, "terminated"), ("noview", 16, "ragged"),
    ("w64", 32, "ragged"), ("w64", 16, "terminated"), ("w64nv", 64, "ragged"),
    ("w32", 32, "ragged")])
def test_carry_march_shapes_and_edge_cases(dev, which, SB, case):
    """K6 against its plain version on 6 tiles at SB 16, 32 and 64, widths
    256 and 128 and zero-padded widths 64 and 32, with and without the
    view branch: rgb/acc/w/transmittance atol 5e-3, depth 5e-3·far, and
    identical executed (tile, block) pairs, for an all-dead launch, a
    single live tile, terminated rays and ragged live rows."""
    rng = np.random.default_rng(13)
    NB, eps, far = 3, 1e-3, 6.0
    R = 6 * (K.TILE_ROWS // SB)
    net = posenc_mlp.pack_params(FIELD_NETS[which](rng).to(dev),
                                 hoist_x=False)
    ro, rd = _rays(R, dev)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    hit, bhit, t, d = _march_case(rng, case, R, NB, SB, dev)
    args = (net, dp, ro, rd, hit, bhit, t, d, math.log(eps))
    n0 = K.LAUNCHES["carry_march"]
    out_k = carrymarch.carry_march(*args)
    out_p = carrymarch.carry_march_plain(*args)
    assert K.LAUNCHES["carry_march"] == n0 + NB
    for name, a, b, tol in zip(("rgb", "depth", "acc", "w"), out_k, out_p,
                               (5e-3, 5e-3 * far, 5e-3, 5e-3)):
        assert float((a - b).abs().max()) <= tol, name
    _close(out_k[4].exp(), out_p[4].exp(), 5e-3)
    live_k = _executed(out_k[3], hit, bhit, eps)
    live_p = _executed(out_p[3], hit, bhit, eps)
    assert torch.equal(live_k, live_p)
    n_exec = int(live_k.sum())
    if case == "all_dead":
        assert n_exec == 0
        assert all(bool((x == 0).all()) for x in out_k)
    elif case == "one_tile":
        assert n_exec == NB and bool(live_k[3].all())
    else:
        cand = (hit[:, None] * bhit).view(-1, K.TILE_ROWS // SB, NB)
        assert 0 < n_exec <= int((cand.amax(dim=1) > 0).sum())


def test_carry_march_wrapper_splits_and_rejects(dev, monkeypatch):
    """More tiles than one launch takes are marched in ranges of rays (the
    same outputs as one launch); SB outside the reference's (24, 1024),
    ragged tiles and a
    net that cannot be padded raise ValueError; R = 0 launches nothing."""
    rng = np.random.default_rng(14)
    NB, SB = 2, 32
    R = 4 * (K.TILE_ROWS // SB)
    net = posenc_mlp.pack_params(prop_net(rng).to(dev), hoist_x=False)
    ro, rd = _rays(R, dev)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    hit, bhit, t, d = _march_case(rng, "ragged", R, NB, SB, dev)
    args = (net, dp, ro, rd, hit, bhit, t, d, math.log(1e-3))
    whole = carrymarch.carry_march(*args)
    monkeypatch.setattr(K, "MARCH_MAX_TILES", 3)
    n0 = K.LAUNCHES["carry_march"]
    split = carrymarch.carry_march(*args)
    assert K.LAUNCHES["carry_march"] == n0 + 2 * NB
    for a, b in zip(whole, split):
        assert torch.equal(a, b)

    def call(net_, R_, SB_):
        S = NB * SB_
        return carrymarch.carry_march(
            net_, torch.zeros((R_, net_.width // 2), dtype=torch.bfloat16,
                              device=dev), ro[:R_].contiguous(),
            rd[:R_].contiguous(), torch.ones(R_, device=dev),
            torch.ones((R_, NB), device=dev), torch.ones((R_, S), device=dev),
            torch.ones((R_, S), device=dev), -6.9)

    wide = posenc_mlp.pack_params(small_net(rng, 512, 3, 4, False).to(dev),
                                  hoist_x=False)
    for bad in (lambda: call(net, 340, 24), lambda: call(net, 96, 32),
                lambda: call(wide, 64, 32), lambda: call(net, 8, 1024)):
        with pytest.raises(ValueError):
            bad()
    n0 = K.LAUNCHES["carry_march"]
    out = call(net, 0, 32)
    assert out[0].shape == (0, 3) and out[3].shape == (0, 64)
    assert K.LAUNCHES["carry_march"] == n0


@pytest.mark.parametrize("mode,width,depth,relu", [
    ("chain", 256, 9, False), ("chain", 256, 9, True),
    ("streams", 256, 9, True), ("dependent", 512, 9, False),
    ("dependent", 256, 3, False), ("independent", 1024, 4, False),
    ("independent", 256, 9, False), ("chain", 192, 9, True),
    ("streams", 192, 9, True), ("dependent", 192, 9, False),
    ("independent", 192, 9, False), ("chain", 512, 3, True),
    ("independent", 768, 3, False), ("dependent", 64, 3, False),
    ("hold", 256, 9, True), ("hold", 256, 9, False), ("hold", 192, 2, True)])
def test_tc_probe_kernel(dev, mode, width, depth, relu):
    """P1/P2 against the plain chain, each one launch: relative RMS 1e-2
    and every element within 2e-2 of the plain output's largest magnitude
    (bf16 1-ulp flips of an activation carry into the next layers). Widths
    that are no multiple of 256 run zero-padded."""
    from fashion_nerf_torch import probe
    x, ws = probe.make_inputs(4096, width, depth, 0.06, 3, dev)
    key = "probe_p1" if mode in ("chain", "streams", "hold") else "probe_p2"
    n0 = K.LAUNCHES[key]
    got = probe.tc_chain(x, ws, mode, relu)
    want = probe.tc_chain_plain(x, ws, mode, relu)
    assert K.LAUNCHES[key] == n0 + 1
    assert got.shape == (4096, width)
    assert _rel_rms(got, want) <= 1e-2
    assert float((got - want).abs().max()) <= 2e-2 * float(
        want.abs().max())


@pytest.mark.parametrize("mode,width,depth,relu,launches", [
    ("streams", 512, 5, True, 2), ("chain", 768, 3, True, 4),
    ("chain", 864, 2, False, 3), ("dependent", 1024, 2, False, 2),
    ("streams", 528, 4, True, 6)])
def test_tc_probe_composed_shapes(dev, mode, width, depth, relu, launches):
    """Shapes whose tiles do not fit one launch (a chain over 512 wide, two
    streams over 256) are composed of the kernel's launches and hold the
    same bounds; 320 rows, so the last work item is half empty."""
    from fashion_nerf_torch import probe
    x, ws = probe.make_inputs(320, width, depth, 0.04, 4, dev)
    key = "probe_p1" if mode in ("chain", "streams") else "probe_p2"
    n0 = K.LAUNCHES[key]
    got = probe.tc_chain(x, ws, mode, relu)
    want = probe.tc_chain_plain(x, ws, mode, relu)
    assert K.LAUNCHES[key] == n0 + launches
    assert _rel_rms(got, want) <= 1e-2
    assert float((got - want).abs().max()) <= 2e-2 * float(
        want.abs().max())
    for bad in (lambda: probe.tc_chain(x[:, :24].contiguous(), ws, mode),
                lambda: probe.tc_chain(x[:100].contiguous(), ws, mode),
                lambda: probe.tc_chain(x, ws[:1], "streams"),
                lambda: probe.tc_chain(x, ws, "hold")):
        with pytest.raises(ValueError):
            bad()


def test_wrappers_reject_bad_inputs(dev):
    rng = np.random.default_rng(3)
    net = posenc_mlp.pack_params(fine_net(rng).to(dev), hoist_x=False)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, 1, 3, dev=dev)).contiguous()
    pts = _f32(rng, 64, 3, dev=dev)
    with pytest.raises(TypeError):
        posenc_mlp.field_rows(net, pts.double(), dp, 64)
    with pytest.raises(ValueError):
        posenc_mlp.field_rows(net, pts.t().contiguous().t(), dp, 64)
    with pytest.raises(ValueError):
        posenc_mlp.field_rows(net, pts[:48].contiguous(), dp, 48)
    with pytest.raises(ValueError):
        posenc_mlp.field_rows(net, pts.cpu(), dp, 64)


def _rel_rms(a, b) -> float:
    """‖a − b‖ / ‖b‖ over all elements (RMS relative to the plain's RMS)."""
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def _bwd_inputs(rng, net, n, spr, dev):
    pts = _f32(rng, n, 3, lo=-1.2, hi=1.2, dev=dev)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, n // spr, 3, dev=dev))
    g_rgb = _f32(rng, n, 3, dev=dev)
    g_sig = _f32(rng, n, dev=dev)
    return pts, dp.contiguous(), g_rgb, g_sig


@pytest.mark.parametrize("spr,n,chunk", [(64, 4096, None), (96, 3072, 1024),
                                         (1, 1024, None), (192, 3072, 640),
                                         (64, 4160, None), (1, 1088, None),
                                         (64, 4160, 1088), (192, 3264, 704)])
def test_field_backward_kernel(dev, monkeypatch, spr, n, chunk):
    """K4 against its plain version: every output within 1e-2 relative RMS,
    over one or several passes (chunk), any samples per ray and half work
    items (n or the pass ≡ 64 mod 128); and twice the same inputs give
    bitwise the same gradients."""
    rng = np.random.default_rng(4)
    net = posenc_mlp.pack_params(fine_net(rng).to(dev), hoist_x=False)
    args = _bwd_inputs(rng, net, n, spr, dev)
    if chunk is not None:
        monkeypatch.setattr(K, "BWD_CHUNK_ROWS", chunk)
    n0 = K.LAUNCHES["field_bwd"]
    out_k = posenc_mlp.field_rows_backward(net, *args, spr)
    out_k2 = posenc_mlp.field_rows_backward(net, *args, spr)
    out_p = posenc_mlp.field_rows_backward_plain(net, *args, spr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["field_bwd"] == n0 + 2
    for name, a, a2, b in zip(("d_pts", "d_dir", "d_w", "d_b"), out_k,
                              out_k2, out_p):
        assert a.shape == b.shape, name
        assert _rel_rms(a, b) <= 1e-2, (name, _rel_rms(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.parametrize("which,n,spr,chunk", [
    ("prop", 2048, 64, None), ("prop", 4160, 64, 1088),
    ("noview", 1088, 1, None), ("noview", 4160, 64, 640)])
def test_field_backward_kernel_no_viewdirs(dev, monkeypatch, which, n, spr,
                                           chunk):
    """The 4-wide head (no view branch) and a padded posenc operand (L = 6,
    k0 = 48), at widths 128 and 256, over one or several passes; bitwise
    the same over two runs."""
    rng = np.random.default_rng(5)
    net = posenc_mlp.pack_params(FIELD_NETS[which](rng).to(dev),
                                 hoist_x=False)
    args = _bwd_inputs(rng, net, n, spr, dev)
    if chunk is not None:
        monkeypatch.setattr(K, "BWD_CHUNK_ROWS", chunk)
    out_k = posenc_mlp.field_rows_backward(net, *args, spr)
    out_k2 = posenc_mlp.field_rows_backward(net, *args, spr)
    out_p = posenc_mlp.field_rows_backward_plain(net, *args, spr)
    for name, a, a2, b in zip(("d_pts", "d_dir", "d_w", "d_b"), out_k,
                              out_k2, out_p):
        if name != "d_dir":
            assert _rel_rms(a, b) <= 1e-2, (name, _rel_rms(a, b))
        assert torch.equal(a, a2), name
    assert bool((out_k[1] == 0).all())


@pytest.mark.parametrize("which", ["fine", "prop", "w32", "w64"])
def test_fused_field_gradients_kernel_vs_plain(dev, which):
    """A loss through make_fused_field on the card: K3 + K4 against the
    plain versions, every parameter's gradient within 1e-2 relative RMS
    (24 rays × 40 samples: 960 rows, a half work item at the end); the
    small nets run zero-padded and their gradients reach the unpadded
    parameters."""
    rng = np.random.default_rng(6)
    model = FIELD_NETS[which](rng).to(dev)
    pts = _f32(rng, 24, 40, 3, lo=-1.2, hi=1.2, dev=dev)
    dirs = _f32(rng, 24, 3, dev=dev)
    grads = []
    for plain in (False, True):
        model.zero_grad()
        with K.plain_versions() if plain else contextlib.nullcontext():
            rgb, sig = posenc_mlp.make_fused_field()(model, pts, dirs)
            (rgb.square().mean() + 0.01 * torch.relu(sig).square().mean()
             ).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert _rel_rms(a, b) <= 1e-2


@pytest.mark.parametrize("S", [1, 31, 37, 64, 192, 200, 2052])
@pytest.mark.parametrize("white", [False, True])
def test_volrend_kernel(dev, S, white):
    """K5 against its plain version: rgb, acc and weights atol 1e-4, depth
    1e-4·far, on rays that do and do not saturate. R = 100 is no multiple
    of a block's 8 rays; S = 1 and 31 leave lanes of the warp idle, 37 and
    200 end inside a round of 32, 2052 is a long ray."""
    from fashion_nerf_torch.kernels import render
    rng = np.random.default_rng(7)
    R = 100
    rgb = _f32(rng, R, S, 3, lo=0.0, hi=1.0, dev=dev)
    sigma = _f32(rng, R, S, lo=-20.0, hi=60.0, dev=dev)
    if S > 1000:
        sigma = sigma * 0.05                      # weight far along the ray
    sigma[:20] = -1.0                             # empty rays
    t = torch.sort(_f32(rng, R, S, lo=2.0, hi=6.0, dev=dev), dim=1).values
    dnorm = _f32(rng, R, lo=0.8, hi=1.3, dev=dev)
    n0 = K.LAUNCHES["volrend"]
    out_k = render.volrend(rgb, sigma, t, dnorm, white)
    out_p = render.volrend_plain(rgb, sigma, t, dnorm, white)
    assert K.LAUNCHES["volrend"] == n0 + 1
    for name, a, b, tol in zip(("rgb", "depth", "acc", "weights"), out_k,
                               out_p, (1e-4, 6e-4, 1e-4, 1e-4)):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= tol, name
    if S > 1000:
        assert float(out_k[3][:, 1100:].max()) > 1e-4


@pytest.mark.parametrize("case", ["softplus", "offset", "one_ray", "no_ray"])
def test_volrend_kernel_cases(dev, case):
    """K5 with the softplus density, with inputs that are views at a
    4-byte offset (not 16-byte aligned), on one ray, and on none."""
    from fashion_nerf_torch.kernels import render
    rng = np.random.default_rng(11)
    R, S = {"one_ray": 1, "no_ray": 0}.get(case, 67), 64
    pad = 1 if case == "offset" else 0

    def view(x):
        flat = torch.empty(x.numel() + pad, device=dev)
        flat[pad:] = x.flatten()
        return flat[pad:].view(x.shape)

    rgb = view(_f32(rng, R, S, 3, lo=0.0, hi=1.0, dev=dev))
    sigma = view(_f32(rng, R, S, lo=-5.0, hi=30.0, dev=dev))
    t = view(torch.sort(_f32(rng, R, S, lo=2.0, hi=6.0, dev=dev),
                        dim=1).values)
    dnorm = _f32(rng, R, lo=0.8, hi=1.3, dev=dev)
    if pad:
        assert rgb.data_ptr() % 16 == 4 and rgb.is_contiguous()
    soft = case == "softplus"
    out_k = render.volrend(rgb, sigma, t, dnorm, True, soft)
    out_p = render.volrend_plain(rgb, sigma, t, dnorm, True, soft)
    torch.cuda.synchronize()
    for name, a, b, tol in zip(("rgb", "depth", "acc", "weights"), out_k,
                               out_p, (1e-4, 6e-4, 1e-4, 1e-4)):
        assert a.shape == b.shape, name
        if R:
            assert float((a - b).abs().max()) <= tol, name


def test_cli_eval_launches_kernels_only(dev, tmp_path, monkeypatch, capsys):
    """`eval` through `cli.main` on the card, from a checkpoint of a random
    full-width `blender_lego` state: the occupancy sweep launches K3, the
    frame K1 and K2, a proposal is distilled for the weights, and no plain
    version of a kernel is called."""
    import json

    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch import cli
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    from fashion_nerf_torch.kernels import render
    from fashion_nerf_torch.train.state import create_train_state

    def refuse(name):
        def fn(*a, **kw):
            raise AssertionError(f"{name} called on the card")
        return fn

    for mod, name in ((posenc_mlp, "field_rows_plain"),
                      (sigmamarch, "sigma_march_plain"),
                      (slimmarch, "slim_march_plain"),
                      (carrymarch, "carry_march_plain"),
                      (render, "volrend_plain")):
        monkeypatch.setattr(mod, name, refuse(name))
    ovr = ["proposal.distill_steps=20", "occupancy.sigma_threshold=0.0",
           f"out_dir={tmp_path}"]
    cfg = load_config("blender_lego", ovr)
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               torch.Generator(dev).manual_seed(0), dev)
    ckpt_lib.save(str(tmp_path / "blender_lego" / "ckpt"), state)
    scene = make_synthetic_scene(n_views=2, H=40, W=40, n_samples=32)
    K.reset_launches()
    argv = ["eval", "--config", "blender_lego", "--out", str(tmp_path)]
    for kv in ovr[:2]:
        argv += ["--set", kv]
    assert cli.main(argv, dataset=scene) == 0
    torch.cuda.synchronize()
    cap = capsys.readouterr()
    row = json.loads(cap.out.strip().splitlines()[-1])
    assert math.isfinite(row["psnr"]) and row["n_views"] == 1
    assert "proposal distilled in 20 steps" in cap.err
    assert all(K.LAUNCHES[k] > 0 for k in ("field", "sigma_march",
                                           "slim_march"))


def test_train_step_kernel_vs_plain(dev, monkeypatch):
    """One training step of a small field on the card, kernels (K3 + K4)
    against the plain versions: the same nets, batch and sparsity points,
    and the plain step replays the kernel step's fine samples (the
    inverse CDF turns last-bit differences of the coarse pass into sample
    moves). Loss rel 1e-3, every gradient within 1e-2 relative RMS."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    from fashion_nerf_torch.models.nerf_mlp import init_field
    from fashion_nerf_torch.render import renderer
    from fashion_nerf_torch.train.loop import TrainStep, sparsity_points
    from fashion_nerf_torch.train.state import TrainState, make_optimizer
    cfg = load_config("blender_lego", [
        "model.net_depth=3", "model.net_width=128", "model.posenc_xyz=6",
        "model.skips=1", "train.batch_rays=256", "sampling.n_coarse=32",
        "sampling.n_fine=32", "sampling.perturb=false"])
    s = make_synthetic_scene(n_views=2, H=24, W=24, n_samples=32)
    ds = RayDataset(s["images"], s["poses"], s["focal"], device=dev)
    idx = torch.arange(0, ds.n_rays, ds.n_rays // 256, device=dev)[:256]
    batch = {k: v[idx] for k, v in ds.batch_arrays().items()}
    pts = sparsity_points(cfg, torch.Generator(dev).manual_seed(0), dev)
    orig, fine_t, out = renderer.sample_pdf, [], {}

    def sampler(*a, **kw):
        if fine_t:
            return fine_t[0]
        fine_t.append(orig(*a, **kw))
        return fine_t[0]

    monkeypatch.setattr(renderer, "sample_pdf", sampler)
    for plain in (False, True):
        g = torch.Generator().manual_seed(5)
        nets = [init_field(cfg.model, g, dev) for _ in range(2)]
        state = TrainState(0, nets[0], nets[1], make_optimizer(
            cfg, [p for n in nets for p in n.parameters()]),
            torch.Generator(dev))
        n0 = dict(K.LAUNCHES)
        with K.plain_versions() if plain else contextlib.nullcontext():
            loss, _ = TrainStep(cfg, ds, streamed=True).loss(
                state, batch, sparsity_pts=pts)
            loss.backward()
        fwd = K.LAUNCHES["field"] - n0["field"]
        bwd = K.LAUNCHES["field_bwd"] - n0["field_bwd"]
        assert (fwd, bwd) == ((0, 0) if plain else (4, 4))
        out[plain] = (float(loss), [p.grad for n in nets
                                    for p in n.parameters()])
    (lk, gk), (lp, gp) = out[False], out[True]
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    for a, b in zip(gk, gp):
        assert _rel_rms(a, b) <= 1e-2


# --- the cond window: conditioned nets (try-on) ------------------------------

def cond_net(rng, W=256, L=10, C=64, depth=8, skip=5, vd=True):
    """A conditioned random field: trunk_0 and the skip layer take C cond
    rows after the posenc rows, as the reference's conditioned NeRFMLP."""
    cx = 3 * (2 * L + 1)
    shapes = {f"trunk_{i}": ((cx + C + W) if i == skip else
                             (cx + C if i == 0 else W), W)
              for i in range(depth)}
    if vd:
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
    else:
        shapes["out_head"] = (W, 4)
    return load_flax_params({"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32),
            "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
        for name, (i, o) in shapes.items()}}, compute_dtype="bfloat16",
        cond_dim=C)


COND_NETS = {"fine": lambda rng: cond_net(rng),
             "w32": lambda rng: cond_net(rng, W=32, L=4, C=16, depth=3,
                                         skip=None),
             "w64skip": lambda rng: cond_net(rng, W=64, L=6, C=24, depth=4,
                                             skip=2, vd=False),
             # the skip layer last: its cotangent comes from the heads
             "w32last": lambda rng: cond_net(rng, W=32, L=4, C=16, depth=3,
                                             skip=2),
             "w32lastnv": lambda rng: cond_net(rng, W=32, L=4, C=16, depth=3,
                                               skip=2, vd=False)}


@pytest.mark.parametrize("which,n,spr", [
    ("fine", 4096, 64), ("fine", 4160, 64), ("fine", 3072, 192),
    ("fine", 1088, 1), ("w32", 4160, 64), ("w64skip", 3072, 96)])
def test_field_kernel_cond_window(dev, which, n, spr):
    """K3 with a condpart (n / spr rays, n_cond·W bf16) against its plain
    version, on the full-width conditioned net and on zero-padded 3×32 and
    4×64 nets (each W-wide slice padded): rgb 5e-3, σ 2e-2·(1+|σ|), every
    row; a condpart of zeros gives the unconditioned net's output."""
    rng = np.random.default_rng(11)
    net = posenc_mlp.pack_params(COND_NETS[which](rng).to(dev),
                                 hoist_x=False)
    R = n // spr
    pts = _f32(rng, n, 3, lo=-1.2, hi=1.2, dev=dev)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, R, 3, dev=dev)).contiguous()
    cond = torch.tensor(rng.normal(size=(R, net.cond_kernel.shape[0])),
                        dtype=torch.float32, device=dev)
    cp = posenc_mlp.hoist_cond(net, cond)
    n0 = dict(K.LAUNCHES)
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, spr, cp)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, spr, cp)
    torch.cuda.synchronize()
    assert K.LAUNCHES["field_cond"] == n0["field_cond"] + 1
    assert K.LAUNCHES["field"] == n0["field"]
    _close(rgb_k, rgb_p, 5e-3)
    assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())
    rgb_0, _ = posenc_mlp.field_rows(net, pts, dp, spr,
                                     torch.zeros_like(cp))
    assert float((rgb_0 - rgb_k).abs().max()) > 1e-3      # cond is live
    with pytest.raises(ValueError):
        posenc_mlp.field_rows(net, pts, dp, spr)           # no condpart


@pytest.mark.parametrize("which,n,spr", [
    ("fine", 4096, 64), ("fine", 4160, 64), ("fine", 3072, 192),
    ("fine", 1088, 1), ("fine", 131136, 192), ("w32", 4160, 64),
    ("w64skip", 3072, 96), ("w32last", 4160, 64), ("w32lastnv", 1088, 1)])
def test_field_bwd_kernel_cond(dev, which, n, spr):
    """K4 with a condpart (its dcond output) against its plain version, on
    the full-width conditioned net (a pass boundary inside a ray at 131,136
    rows) and on zero-padded 3×32 and 4×64 nets (the skip layer also the
    last trunk layer, with and without the view branch): each of the five
    outputs 1e-2 relative RMS, in the unpadded layout, bitwise the same
    over two runs, counted under "field_bwd_cond"; a condpart of zeros
    moves d_condpart and leaves its shape."""
    rng = np.random.default_rng(12)
    net = posenc_mlp.pack_params(COND_NETS[which](rng).to(dev),
                                 hoist_x=False)
    args = _bwd_inputs(rng, net, n, spr, dev)
    R = n // spr
    cond = torch.tensor(rng.normal(size=(R, net.cond_kernel.shape[0])),
                        dtype=torch.float32, device=dev)
    cp = posenc_mlp.hoist_cond(net, cond)
    n0 = dict(K.LAUNCHES)
    out_k = posenc_mlp.field_rows_backward(net, *args, spr, cp)
    out_k2 = posenc_mlp.field_rows_backward(net, *args, spr, cp)
    out_p = posenc_mlp.field_rows_backward_plain(net, *args, spr, cp)
    out_0 = posenc_mlp.field_rows_backward(net, *args, spr,
                                           torch.zeros_like(cp))
    torch.cuda.synchronize()
    assert K.LAUNCHES["field_bwd_cond"] == n0["field_bwd_cond"] + 3
    assert K.LAUNCHES["field_bwd"] == n0["field_bwd"]
    assert len(out_k) == 5 and out_k[4].shape == (R, net.n_cond * net.width)
    for name, a, a2, b in zip(("d_pts", "d_dir", "d_w", "d_b", "d_cond"),
                              out_k, out_k2, out_p):
        assert a.shape == b.shape, name
        assert torch.equal(a, a2), name
        if name == "d_dir" and not net.has_vd:
            continue
        assert _rel_rms(a, b) <= 1e-2, (name, _rel_rms(a, b))
    assert _rel_rms(out_0[4], out_k[4]) > 1e-3            # cond is live


def _cond_march_case(rng, dev, R=192, NB=3, SB=32):
    """Rays whose predication differs between the 64-ray and the 32-ray
    tile: rays [32, 64) dead (half of the first 64-ray tile), one culled
    ray in a live tile, a dead (tile, block) pair of the halved tile."""
    model = cond_net(rng).to(dev)
    ro, rd = _rays(R, dev)
    t = torch.linspace(2.0, 6.0, NB * SB, device=dev).expand(
        R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 4.0 / (NB * SB), device=dev)
    hit = torch.ones(R, device=dev)
    hit[32:64] = 0.0
    hit[100] = 0.0
    bhit = torch.ones((R, NB), device=dev)
    bhit[160:, 1] = 0.0
    cond = torch.tensor(rng.normal(size=(R, 64)), dtype=torch.float32,
                        device=dev)
    return model, ro, rd, t, d, hit, bhit, cond


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_cond_marches_halved_tile(dev, eps):
    """K2 with the cond folded into oX and K6 with its cond window, the
    conditioned fine net at the halved tile (32 rays at SB = 32): each
    kernel against its plain version (rgb/w 5e-3), identical executed
    (tile, block) pairs, and K6 against K2 within 5e-3."""
    from fashion_nerf_torch.render.blockwise import march_liveness
    rng = np.random.default_rng(12)
    model, ro, rd, t, d, hit, bhit, cond = _cond_march_case(rng, dev)
    log_eps = math.log(eps) if eps > 0 else -1e30
    cfg = SimpleNamespace(kernels=SimpleNamespace(early_term_eps=eps))
    snet = slimmarch.split_hoist(model)
    cnet = posenc_mlp.pack_params(model, hoist_x=False)
    assert snet.tile_rows == cnet.tile_rows == K.TILE_ROWS // 2
    dp = posenc_mlp.hoist_dirs(snet, rd).contiguous()
    cp = posenc_mlp.hoist_cond(snet, cond)
    hf = slimmarch.hoist_rays(snet, ro, rd, cp)
    n0 = dict(K.LAUNCHES)
    s_k = slimmarch.slim_march(snet, hf, dp, hit, bhit, t, d, log_eps)
    s_p = slimmarch.slim_march_plain(snet, hf, dp, hit, bhit, t, d, log_eps)
    args = (cnet, dp, ro, rd, hit, bhit, t, d, log_eps)
    c_k = carrymarch.carry_march(*args, condpart=cp)
    c_p = carrymarch.carry_march_plain(*args, condpart=cp)
    torch.cuda.synchronize()
    assert K.LAUNCHES["slim_march_cond"] == n0["slim_march_cond"] + 3
    assert K.LAUNCHES["carry_march_cond"] == n0["carry_march_cond"] + 3
    for a, b in ((s_k[0], s_p[0]), (s_k[1], s_p[1]), (c_k[0], c_p[0]),
                 (c_k[3], c_p[3]), (c_k[0], s_k[0]), (c_k[3], s_k[1])):
        _close(a, b, 5e-3)
    ex = [march_liveness(w, hit, bhit, cfg, tile_rows=K.TILE_ROWS // 2)[
        "tile_alive"] for w in (s_k[1], s_p[1], c_k[3], c_p[3])]
    for e in ex[1:]:
        assert torch.equal(ex[0], e)
    assert not bool(ex[0][1].any())               # rays [32, 64): dead tile
    assert bool((s_k[1][32:64] == 0).all()) and bool((c_k[3][32:64] == 0)
                                                     .all())
    assert bool((s_k[1][160:, 32:64] == 0).all())
    assert float(c_k[2][100]) > 0.0               # culled ray, live tile
    with pytest.raises(ValueError):
        carrymarch.carry_march(*args)              # a conditioned net, no cp


@pytest.mark.parametrize("which,SB", [("w32", 32), ("w64skip", 16)])
def test_carry_march_cond_padded_nets(dev, which, SB):
    """K6's cond window on zero-padded conditioned nets (3×32 with one
    conditioned layer, 4×64 with a skip layer and no view branch): each
    W-wide condpart slice padded to 128, against the plain version on the
    unpadded net (rgb/w/acc 5e-3) at the conditioned tile, executed pairs
    equal."""
    from fashion_nerf_torch.render.blockwise import march_liveness
    rng = np.random.default_rng(13)
    net = posenc_mlp.pack_params(COND_NETS[which](rng).to(dev),
                                 hoist_x=False)
    R, NB = 2 * (K.TILE_ROWS // 2 // SB), 2
    ro, rd = _rays(R, dev)
    t = torch.linspace(2.0, 6.0, NB * SB, device=dev).expand(
        R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 4.0 / (NB * SB), device=dev)
    hit = torch.ones(R, device=dev)
    hit[R // 2:] = 0.0                        # the second tile dead
    bhit = torch.ones((R, NB), device=dev)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    cp = posenc_mlp.hoist_cond(net, torch.tensor(
        rng.normal(size=(R, net.cond_kernel.shape[0])), dtype=torch.float32,
        device=dev))
    args = (net, dp, ro, rd, hit, bhit, t, d, -1e30)
    out_k = carrymarch.carry_march(*args, condpart=cp)
    out_p = carrymarch.carry_march_plain(*args, condpart=cp)
    torch.cuda.synchronize()
    assert net.padded is not None and net.padded.width == 128
    for i in (0, 2, 3):
        _close(out_k[i], out_p[i], 5e-3)
    cfg = SimpleNamespace(kernels=SimpleNamespace(early_term_eps=0.0))
    ex = [march_liveness(o[3], hit, bhit, cfg, tile_rows=net.tile_rows)[
        "tile_alive"] for o in (out_k, out_p)]
    assert torch.equal(ex[0], ex[1]) and not bool(ex[0][1].any())


ALIVE_NETS = {"fine": fine_net, "prop": prop_net, "cond": cond_net,
              "w32": lambda rng: small_net(rng, 32, 3, 4, True)}


@pytest.mark.parametrize("which,tiles,spr,case", [
    ("fine", 4, 32, "live"), ("fine", 4, 32, "dead"),
    ("fine", 4, 32, "alternate"), ("fine", 0, 32, "alternate"),
    ("prop", 4, 64, "alternate"), ("cond", 4, 32, "alternate"),
    ("cond", 4, 32, "live"), ("w32", 3, 32, "alternate")])
def test_field_kernel_alive(dev, which, tiles, spr, case):
    """K3 with the tile-skip flag (`alive`, one f32 per tile of
    net.tile_rows rows: 2048, 1024 for the conditioned net; tiles 0 means
    one tile of 1024 rows, shorter than a tile): live rows bitwise equal to
    K3 without the flag, dead rows exactly rgb 0 and σ −1e10, all rows
    against the plain version with the flag (rgb 5e-3, σ 2e-2·(1+|σ|));
    all live is bitwise the run without the flag; counted under
    "field_alive"."""
    rng = np.random.default_rng(12)
    model = ALIVE_NETS[which](rng).to(dev)
    net = posenc_mlp.pack_params(model, hoist_x=False)
    n = tiles * net.tile_rows if tiles else 1024
    tile = min(net.tile_rows, n)
    R = n // spr
    pts = _f32(rng, n, 3, lo=-1.2, hi=1.2, dev=dev)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, R, 3, dev=dev)).contiguous()
    cp = None
    if which == "cond":
        cp = posenc_mlp.hoist_cond(net, torch.tensor(
            rng.normal(size=(R, net.cond_kernel.shape[0])),
            dtype=torch.float32, device=dev))
    flags = {"live": [1.0] * (n // tile), "dead": [0.0] * (n // tile),
             "alternate": [float(i % 2 == 0) for i in range(n // tile)]}
    alive = torch.tensor(flags[case], device=dev)
    n0 = dict(K.LAUNCHES)
    rgb_f, sig_f = posenc_mlp.field_rows(net, pts, dp, spr, cp)
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, spr, cp, alive=alive)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, spr, cp,
                                               alive=alive)
    torch.cuda.synchronize()
    assert K.LAUNCHES["field_alive"] == n0["field_alive"] + 1
    live = (alive > 0).repeat_interleave(tile)
    assert torch.equal(rgb_k[live], rgb_f[live])
    assert torch.equal(sig_k[live], sig_f[live])
    assert bool((rgb_k[~live] == 0).all())
    assert bool((sig_k[~live] == posenc_mlp.DEAD_SIGMA).all())
    _close(rgb_k, rgb_p, 5e-3)
    assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())
    with pytest.raises(ValueError):
        posenc_mlp.field_rows(net, pts, dp, spr, cp, alive=alive[:-1]
                              if alive.numel() > 1 else alive.repeat(2))


@pytest.mark.parametrize("which,NB,SB,eps", [
    ("prop", 1, 64, 0.0), ("prop", 1, 64, 1e-3), ("prop", 3, 32, 1e-3),
    ("noview", 2, 32, 1e-3)])
def test_slim_march_kernel_no_view_branch(dev, which, NB, SB, eps):
    """K2 on a net without a view branch (the σ-only proposal net, 2×128
    with no skip layer, and 4×256 with a skip layer) against its plain
    version: rgb/w/transmittance atol 2e-3 and identical executed (tile,
    block) pairs, with a dead tile, a culled ray in a live tile and a dead
    (tile, block) pair; with one block of 64 against K1 on the same input
    (w atol 2e-3, the reference's σ-march bound); counted under
    "slim_march_novd"."""
    rng = np.random.default_rng(13)
    model = (prop_net if which == "prop" else noview_net)(rng).to(dev)
    net = slimmarch.split_hoist(model)
    assert not net.has_vd
    R, S = 6 * (K.TILE_ROWS // SB), NB * SB
    rpt = K.TILE_ROWS // SB
    ro, rd = _rays(R, dev)
    hz = slimmarch.hoist_rays(net, ro, rd)
    t = torch.linspace(2.0, 6.0, S, device=dev).expand(R, S).contiguous()
    d = torch.full((R, S), 0.2, device=dev)
    hit = torch.ones(R, device=dev)
    hit[:rpt] = 0.0                   # tile 0 dead
    hit[rpt + 5] = 0.0                # culled ray in live tile 1
    bhit = torch.ones((R, NB), device=dev)
    bhit[2 * rpt:3 * rpt, -1] = 0.0   # tile 2's last block dead
    log_eps = math.log(eps) if eps > 0 else -1e30
    args = (net, hz, None, hit, bhit, t, d, log_eps)
    n0 = dict(K.LAUNCHES)
    out_k = slimmarch.slim_march(*args)
    out_p = slimmarch.slim_march_plain(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["slim_march_novd"] == n0["slim_march_novd"] + NB
    assert K.LAUNCHES["slim_march"] == n0["slim_march"]
    _close(out_k[0], out_p[0], 2e-3)
    _close(out_k[1], out_p[1], 2e-3)
    _close(out_k[2].exp(), out_p[2].exp(), 2e-3)
    assert torch.equal(_executed(out_k[1], hit, bhit, eps),
                       _executed(out_p[1], hit, bhit, eps))
    assert bool((out_k[1][:rpt] == 0).all())
    assert float(out_k[1].sum()) > 0.0
    if which == "prop" and NB == 1:
        alive = (hit * bhit[:, 0]).contiguous()
        w1, acc1, _ = sigmamarch.sigma_march(
            sigmamarch.pack_sigma(model), sigmamarch.hoist_rays(
                sigmamarch.pack_sigma(model), ro, rd), alive, t, d)
        _close(out_k[1], w1, 2e-3)
    with pytest.raises(ValueError):
        slimmarch.slim_march(net, hz, posenc_mlp.hoist_dirs(net, rd), hit,
                             bhit, t, d, log_eps)


# --- several skip layers; the σ march's and K2's other widths ----------------

def skips_net(rng, W=256, L=10, depth=8, skips=(2, 4), vd=True, C=0):
    """A random field whose layers after `skips` take γ(x) (and C cond rows
    with trunk_0's), the reference's NeRFMLP convention."""
    cx = 3 * (2 * L + 1) + C
    shapes = {f"trunk_{i}": ((cx + W) if (i - 1) in skips else
                             (cx if i == 0 else W), W) for i in range(depth)}
    if vd:
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
    else:
        shapes["out_head"] = (W, 4)
    return load_flax_params({"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32),
            "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
        for name, (i, o) in shapes.items()}}, compute_dtype="bfloat16",
        cond_dim=C)


SKIP_NETS = {"fine": lambda rng, C=0: skips_net(rng, C=C),
             "w64": lambda rng, C=0: skips_net(rng, 64, 4, 6, (1, 3), C=C),
             "w128nv": lambda rng, C=0: skips_net(rng, 128, 6, 5, (0, 2),
                                                  vd=False, C=C)}


@pytest.mark.parametrize("depth,width,k0,skips,vd", [
    (8, 256, 64, (5,), 1), (8, 256, 64, (3, 5), 1), (2, 128, 48, (), 0),
    (6, 64, 32, (2, 4), 1), (16, 128, 48, (1, 4, 9, 15), 0)])
def test_layout_matches_python(dev, depth, width, k0, skips, vd):
    """fnt::make_layout (fnt_layout) equals posenc_mlp._layout offset for
    offset, one skip layer or several."""
    import ctypes
    lay = posenc_mlp._layout(depth, width, k0, skips, bool(vd))
    out = (ctypes.c_int * (3 * depth + 10))()
    mask = sum(1 << i for i in skips)
    assert K.library().fnt_layout(depth, width, k0, mask, vd, out) == 0
    got = list(out)
    want = [(-1 if v is None else v) for v in
            lay["w_h"] + lay["w_a0"] + lay["b"]]
    want += [lay.get(k, -1) for k in ("w_sig", "w_feat", "w_view", "w_rgb",
                                      "w_out", "b_sig", "b_feat", "b_view",
                                      "b_rgb", "b_out")]
    assert got == want


@pytest.mark.parametrize("which,n,spr,cond", [
    ("fine", 4160, 64, False), ("fine", 3072, 192, True),
    ("w64", 4096, 64, False), ("w64", 1088, 1, True),
    ("w128nv", 4160, 64, True)])
def test_field_kernel_two_skips(dev, which, n, spr, cond):
    """K3 on nets with two skip layers (8×256 L = 10 with layers 3 and 5
    taking γ(x), a padded 6×64 and a 5×128 without a view branch), with
    and without the cond window (n_cond = 3): rgb 5e-3, σ 2e-2·(1+|σ|)."""
    rng = np.random.default_rng(21)
    C = 16 if cond else 0
    net = posenc_mlp.pack_params(SKIP_NETS[which](rng, C=C).to(dev),
                                 hoist_x=False)
    assert len(net.skips) == 2 and net.n_cond == (3 if cond else 0)
    R = n // spr
    pts = _f32(rng, n, 3, lo=-1.2, hi=1.2, dev=dev)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, R, 3, dev=dev)).contiguous()
    cp = posenc_mlp.hoist_cond(net, torch.tensor(
        rng.normal(size=(R, C)), dtype=torch.float32, device=dev)) \
        if cond else None
    key = "field_cond" if cond else "field"
    n0 = K.LAUNCHES[key]
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, spr, cp)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, spr, cp)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == n0 + 1
    _close(rgb_k, rgb_p, 5e-3)
    assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())


@pytest.mark.parametrize("which,n,spr,cond", [
    ("fine", 4096, 64, False), ("fine", 3072, 192, True),
    ("w64", 4160, 64, True), ("w128nv", 1088, 1, False)])
def test_field_bwd_kernel_two_skips(dev, which, n, spr, cond):
    """K4 on two-skip nets: every output (d_pts through both skip layers'
    posenc cotangents, d_dir, d_w, d_b and, conditioned, d_cond over three
    slices) 1e-2 relative RMS against its plain version, bitwise the same
    over two runs."""
    rng = np.random.default_rng(22)
    C = 16 if cond else 0
    net = posenc_mlp.pack_params(SKIP_NETS[which](rng, C=C).to(dev),
                                 hoist_x=False)
    args = _bwd_inputs(rng, net, n, spr, dev)
    cp = posenc_mlp.hoist_cond(net, torch.tensor(
        rng.normal(size=(n // spr, C)), dtype=torch.float32, device=dev)) \
        if cond else None
    out_k = posenc_mlp.field_rows_backward(net, *args, spr, cp)
    out_k2 = posenc_mlp.field_rows_backward(net, *args, spr, cp)
    out_p = posenc_mlp.field_rows_backward_plain(net, *args, spr, cp)
    torch.cuda.synchronize()
    assert len(out_k) == (5 if cond else 4)
    for i, (a, a2, b) in enumerate(zip(out_k, out_k2, out_p)):
        assert torch.equal(a, a2), i
        if i == 1 and not net.has_vd:
            continue
        assert _rel_rms(a, b) <= 1e-2, (i, _rel_rms(a, b))


@pytest.mark.parametrize("W", [128, 256])
@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("skips", [(4,), (2, 4)])
def test_field_bwd_rows_kernel_shapes(dev, monkeypatch, W, cond, skips):
    """K4's four rows-kernel instantiations (W 128 and 256, with and
    without the cond window) on its 4-slot ring, one skip layer or two:
    3264 rows, 96 a ray, in passes of 1088 (8.5 work items each, so the
    last item's second warpgroup has no rows while the first still takes
    every slice of the ring). Every output 1e-2 relative RMS against its
    plain version, bitwise the same over two runs."""
    rng = np.random.default_rng(24)
    C = 16 if cond else 0
    net = posenc_mlp.pack_params(
        skips_net(rng, W, skips=skips, C=C).to(dev), hoist_x=False)
    assert net.width == W and net.n_cond == (len(skips) + 1 if cond else 0)
    n, spr = 3264, 96
    monkeypatch.setattr(K, "BWD_CHUNK_ROWS", 1088)
    args = _bwd_inputs(rng, net, n, spr, dev)
    cp = posenc_mlp.hoist_cond(net, torch.tensor(
        rng.normal(size=(n // spr, C)), dtype=torch.float32, device=dev)) \
        if cond else None
    key = "field_bwd_cond" if cond else "field_bwd"
    n0 = K.LAUNCHES[key]
    out_k = posenc_mlp.field_rows_backward(net, *args, spr, cp)
    out_k2 = posenc_mlp.field_rows_backward(net, *args, spr, cp)
    out_p = posenc_mlp.field_rows_backward_plain(net, *args, spr, cp)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == n0 + 2
    assert len(out_k) == (5 if cond else 4)
    for i, (a, a2, b) in enumerate(zip(out_k, out_k2, out_p)):
        assert torch.equal(a, a2), i
        assert _rel_rms(a, b) <= 1e-2, (i, _rel_rms(a, b))


@pytest.mark.parametrize("cond", [False, True])
def test_marches_two_skips(dev, cond):
    """K2 (three hoisted x-layers; the cond folded into their intercepts)
    and K6 (the cond window over three slices) on the 8×256 two-skip net:
    rgb/w 5e-3 against their plain versions and K6 against K2, with a dead
    tile, a dead (tile, block) pair and termination."""
    rng = np.random.default_rng(23)
    C = 16 if cond else 0
    model = skips_net(rng, C=C).to(dev)
    R, NB, SB = 192, 3, 32
    ro, rd = _rays(R, dev)
    t = torch.linspace(2.0, 6.0, NB * SB, device=dev).expand(
        R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 4.0 / (NB * SB), device=dev)
    hit = torch.ones(R, device=dev)
    hit[:64] = 0.0
    bhit = torch.ones((R, NB), device=dev)
    bhit[128:, 1] = 0.0
    cond_v = (torch.tensor(rng.normal(size=(R, C)), dtype=torch.float32,
                           device=dev) if cond else None)
    snet = slimmarch.split_hoist(model)
    cnet = posenc_mlp.pack_params(model, hoist_x=False)
    assert len(snet.x_kernels) == 3
    dp = posenc_mlp.hoist_dirs(snet, rd).contiguous()
    cp = posenc_mlp.hoist_cond(snet, cond_v)
    hf = slimmarch.hoist_rays(snet, ro, rd, cp)
    log_eps = math.log(1e-3)
    s_k = slimmarch.slim_march(snet, hf, dp, hit, bhit, t, d, log_eps)
    s_p = slimmarch.slim_march_plain(snet, hf, dp, hit, bhit, t, d, log_eps)
    args = (cnet, dp, ro, rd, hit, bhit, t, d, log_eps)
    c_k = carrymarch.carry_march(*args, condpart=cp)
    c_p = carrymarch.carry_march_plain(*args, condpart=cp)
    torch.cuda.synchronize()
    for a, b in ((s_k[0], s_p[0]), (s_k[1], s_p[1]), (c_k[0], c_p[0]),
                 (c_k[3], c_p[3]), (c_k[0], s_k[0]), (c_k[3], s_k[1])):
        _close(a, b, 5e-3)
    assert bool((s_k[1][:64] == 0).all()) and float(s_k[1].sum()) > 0.0


@pytest.mark.parametrize("W,depth,L", [(192, 2, 8), (256, 3, 8), (64, 2, 6)])
def test_sigma_march_other_widths_take_k2(dev, W, depth, L):
    """The σ march of a proposal K1 is not built for (the spec sweep's 2×192
    and 3×256 at L = 8, and a 2×64) runs on K2 without a view branch,
    zero-padded to its nearest width: w/acc/transmittance 2e-3 against
    the plain version on the unpadded net, dead tiles exact zeros, counted
    under "sigma_march_k2" and nowhere else."""
    rng = np.random.default_rng(24)
    cx = 3 * (2 * L + 1)
    shapes = {"trunk_0": (cx, W), "out_head": (W, 4)}
    shapes.update({f"trunk_{i}": (W, W) for i in range(1, depth)})
    net = sigmamarch.pack_sigma(_net(rng, shapes).to(dev))
    assert sigmamarch.sigma_kernel(net) == "K2"
    R, SB = 256, 64
    ro, rd = _rays(R, dev)
    hz = sigmamarch.hoist_rays(net, ro, rd)
    t = torch.linspace(2.0, 6.0, SB, device=dev).expand(R, SB).contiguous()
    d = torch.full((R, SB), 4.0 / SB, device=dev)
    alive = torch.ones(R, device=dev)
    alive[:32] = 0.0                  # tile 0 dead
    alive[40] = 0.0                   # culled ray in live tile 1
    n0 = dict(K.LAUNCHES)
    w_k, acc_k, lt_k = sigmamarch.sigma_march(net, hz, alive, t, d)
    w_p, acc_p, lt_p = sigmamarch.sigma_march_plain(net, hz, alive, t, d)
    torch.cuda.synchronize()
    moved = {k for k in K.LAUNCHES if K.LAUNCHES[k] != n0[k]}
    assert moved == {"sigma_march_k2"}
    assert K.LAUNCHES["sigma_march_k2"] == n0["sigma_march_k2"] + 1
    _close(w_k, w_p, 2e-3)
    _close(acc_k, acc_p, 2e-3)
    _close(lt_k.exp(), lt_p.exp(), 2e-3)
    assert bool((w_k[:32] == 0).all() and (acc_k[:32] == 0).all())
    assert float(acc_k[40]) > 0.0


@pytest.mark.parametrize("W,L,skips", [(128, 10, (4,)), (128, 10, (1, 3)),
                                       (64, 6, (2,))])
def test_slim_march_view_branch_width_128(dev, W, L, skips):
    """K2 with a view branch at width 128 (its own instantiation; the view
    layer at N = 64), and a 64-wide net padded to it: rgb/w/transmittance
    5e-3 against the plain version on the unpadded net."""
    rng = np.random.default_rng(25)
    net = slimmarch.split_hoist(skips_net(rng, W, L, 8, skips).to(dev))
    assert slimmarch.march_net(net).width == 128
    R, NB, SB = 192, 3, 32
    ro, rd = _rays(R, dev)
    hf = slimmarch.hoist_rays(net, ro, rd)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    t = torch.linspace(2.0, 6.0, NB * SB, device=dev).expand(
        R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 4.0 / (NB * SB), device=dev)
    hit = torch.ones(R, device=dev)
    hit[:64] = 0.0
    bhit = torch.ones((R, NB), device=dev)
    n0 = K.LAUNCHES["slim_march"]
    out_k = slimmarch.slim_march(net, hf, dp, hit, bhit, t, d, -6.9)
    out_p = slimmarch.slim_march_plain(net, hf, dp, hit, bhit, t, d, -6.9)
    torch.cuda.synchronize()
    assert K.LAUNCHES["slim_march"] == n0 + NB
    _close(out_k[0], out_p[0], 5e-3)
    _close(out_k[1], out_p[1], 5e-3)
    _close(out_k[2].exp(), out_p[2].exp(), 5e-3)
    assert bool((out_k[1][:64] == 0).all()) and float(out_k[1].sum()) > 0.0


# distribution on the card: two ranks over gloo, each on cuda:0, two over
# NCCL each on its own card (tests/torch_dist_worker.py), a group of one
# rank over NCCL, and the stream's prefetch

DIST_OVR = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
            "kernels.use_pallas=true", "sampling.n_coarse=16",
            "sampling.n_fine=16", "sampling.perturb=false",
            "train.batch_rays=64", "train.precrop_iters=0",
            "train.sparsity_points=64"]


def _dist_inputs(tmp_path, n_steps):
    """A small scene, a fresh state's parameters, fed batches and prior
    points, segmented-scan arrays → (npz path, the arrays)."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.train.state import create_train_state
    cfg = load_config("blender_lego", DIST_OVR)
    scene = make_synthetic_scene(n_views=2, H=16, W=16, n_samples=16)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    chain = GeneratorChain(0)
    state = create_train_state(cfg, chain.once("init"), chain.once("run"))
    rng = np.random.default_rng(0)
    arrs = {"scene/images": scene["images"], "scene/poses": scene["poses"],
            "scene/focal": np.float32(scene["focal"])}
    for k, net in state.nets().items():
        for name, leaf in net.to_flax_params()["params"].items():
            for kind, v in leaf.items():
                arrs[f"params/{k}/params/{name}/{kind}"] = v
    host = {k: v.numpy() for k, v in ds.batch_arrays().items()}
    for s in range(n_steps):
        idx = rng.integers(0, ds.n_rays, 64)
        for k, v in host.items():
            arrs[f"batch{s}/{k}"] = v[idx]
        arrs[f"sparsity{s}"] = rng.uniform(-1.5, 1.5, (64, 1, 3)).astype(
            np.float32)
    R, S = 512, 64
    arrs.update({"seg/rgb": rng.uniform(0, 1, (R, S, 3)).astype(np.float32),
                 "seg/sigma": rng.normal(0.5, 2.0, (R, S)).astype(np.float32),
                 "seg/t": np.sort(rng.uniform(2, 6, (R, S)), -1).astype(
                     np.float32),
                 "seg/d": rng.normal(size=(R, 3)).astype(np.float32),
                 "seg/white": np.array(True)})
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **arrs)
    return path, arrs


def test_dp2_step_and_segmented_scan_on_one_card(dev, tmp_path):
    """Two ranks on one card (the first visible; gloo): three dp=2 steps
    through K3/K4 against one process's (step-1 loss 1e-5 relative, every
    step-1 gradient 1e-4 relative RMS, under 1% of parameters more than
    1e-4 apart after 3 steps), and `segmented_ray_scan` at 2 segments
    against `volume_render` (rgb and acc 3e-4, depth 3e-3)."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    ranks = _dp2_against_one_process(dev, tmp_path,
                                     {"CUDA_VISIBLE_DEVICES": first})
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]


def test_dp2_nccl_step_over_two_cards(dev, tmp_path):
    """One rank a card: two ranks, each on its own card over NCCL
    (`dist.mesh.card_plan`), held to the one-card test's bounds against one
    process. Needs two cards; skipped on fewer."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA devices, have "
                    f"{torch.cuda.device_count()}")
    ranks = _dp2_against_one_process(dev, tmp_path, {})
    assert [r["backend"] for r in ranks] == ["nccl", "nccl"]
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    assert [r["card"] for r in ranks] == [0, 1]


def _dp2_against_one_process(dev, tmp_path, env: dict) -> list:
    """Three dp=2 steps and a 2-segment `segmented_ray_scan` in a group of
    two worker ranks started with `env`, against the same in this process
    on `dev` → each rank's backend and device."""
    import torch_dist_worker as worker
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.core.volrend import volume_render
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.train.loop import TrainStep
    from fashion_nerf_torch.train.state import state_from_params
    n = 3
    path, arrs = _dist_inputs(tmp_path, n)
    procs = worker.run_job(str(tmp_path / "job.json"), 2, path,
                           str(tmp_path), [
                               dict(kind="steps", name="dp2", dp=2, tp=1,
                                    config="blender_lego", overrides=DIST_OVR,
                                    streamed=True, n_steps=n, seed=0),
                               dict(kind="segmented", name="seg",
                                    cases=["seg"]),
                               dict(kind="whoami", name="whoami",
                                    every_rank=True)],
                           device="cuda", env=env)
    cfg = load_config("blender_lego", DIST_OVR)
    ds = RayDataset(arrs["scene/images"], arrs["scene/poses"],
                    float(arrs["scene/focal"]), device=dev)
    state = state_from_params(cfg, worker.tree(np.load(path), "params"),
                              torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    step = TrainStep(cfg, ds, streamed=True)
    losses, grads = [], None
    for s in range(n):
        batch = {k: torch.from_numpy(arrs[f"batch{s}/{k}"]).to(dev)
                 for k in ("rays_o", "rays_d", "viewdirs", "rgb",
                           "frame_ids")}
        with torch.enable_grad():
            state, m = step(state, batch, sparsity_pts=torch.from_numpy(
                arrs[f"sparsity{s}"]).to(dev))
        losses.append(float(m["loss"]))
        if s == 0:
            grads = {f"{a}.{b}": p.grad.detach().cpu()
                     for a, net in state.nets().items()
                     for b, p in net.named_parameters()}
    worker.join(procs, "dp2 on the card")
    got = torch.load(tmp_path / "dp2.pt", weights_only=False)
    assert abs(got["losses"][0] - losses[0]) <= 1e-5 * abs(losses[0])
    for k, g in grads.items():
        rel = (got["grads"][k] - g).double().norm() / g.double().norm()
        assert float(rel) <= 1e-4, k
    params = {f"{a}.{b}": p.detach().cpu() for a, net in state.nets().items()
              for b, p in net.named_parameters()}
    far = sum(int(((got["params"][k] - v).abs() > 1e-4).sum())
              for k, v in params.items())
    assert far / sum(v.numel() for v in params.values()) < 0.01
    seg = torch.load(tmp_path / "seg.pt", weights_only=False)["seg"]
    ref = volume_render(*(torch.from_numpy(arrs[f"seg/{k}"]).to(dev)
                          for k in ("rgb", "sigma", "t", "d")),
                        white_bkgd=True)
    for k, tol in (("rgb", 3e-4), ("acc", 3e-4), ("depth", 3e-3)):
        assert float((seg[k] - ref[k].cpu()).abs().max()) <= tol, k
    return [torch.load(tmp_path / f"whoami.{r}.pt", weights_only=False)
            for r in range(2)]



@pytest.mark.parametrize("rows", [None, slice(16, 32)])
def test_prefetch_to_device_matches_a_synchronous_copy(dev, rows):
    """The prefetch's batches (pinned, side stream, event) equal the
    iterator's copied synchronously, a dp rank's rows of them when asked,
    and are ready on the consumer's stream."""
    from fashion_nerf_torch.data.pipeline import (host_batch_iter,
                                                  prefetch_to_device)
    rng = np.random.default_rng(1)
    rays = {"rays_o": rng.normal(size=(4096, 3)).astype(np.float32),
            "frame_ids": rng.integers(0, 9, 4096)}
    want = host_batch_iter(rays, 32, seed=4)
    got = prefetch_to_device(host_batch_iter(rays, 32, seed=4), size=2,
                             device=dev, rows=rows)
    sl = slice(None) if rows is None else rows
    for _ in range(6):
        b, w = next(got), next(want)
        for k in w:
            assert b[k].device.type == "cuda"
            sync = torch.from_numpy(w[k][sl]).to(dev)
            assert torch.equal(b[k] * 1, sync), k


def test_one_rank_nccl_step_is_the_step_without_a_mesh(dev):
    """A group of one rank over NCCL on the card
    (`torch_dist_worker.group_of_one`): three TrainSteps under
    make_mesh(1, 1), through K3/K4 and the mesh's collectives, bitwise the
    steps without a mesh; `reduce_gradients`, `reduce_scalars` and
    `broadcast_` of a bool occupancy grid give back what they were
    given."""
    import torch_dist_worker as worker
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    cfg = load_config("blender_lego", DIST_OVR)
    scene = make_synthetic_scene(n_views=2, H=16, W=16, n_samples=16)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    device=dev)
    got = worker.group_of_one(cfg, ds, torch.device("cuda", 0))
    assert (got["backend"], got["card"]) == ("nccl", 0)
    assert got["launches"]["field_bwd"] > 0
    assert got["bitwise"] == {"losses": True, "grads": True, "params": True}
    assert all(got["collectives"].values()), got["collectives"]


# each kernel on the last card (cuda:0 on a one-card host) while torch's
# current device stays cuda:0: the wrappers launch on their operands' card
LAST_CARD_CASES = {
    "K1": lambda d, mp: test_sigma_march_kernel(d, "mixed"),
    "K2": lambda d, mp: test_slim_march_kernel(d, 1e-3),
    "K3": lambda d, mp: test_field_kernel(d, "fine", 3072, 192),
    "K4": lambda d, mp: test_field_backward_kernel(d, mp, 192, 3072, 640),
    "K5": lambda d, mp: test_volrend_kernel(d, 192, True),
    "K6": lambda d, mp: test_carry_march_kernel(d, 1e-3),
    "P1": lambda d, mp: test_tc_probe_kernel(d, "chain", 256, 9, True),
    "K8": lambda d, mp: test_box_cull_kernel_cases(d, "generic", 16, 5000,
                                                   12, 8),
}


@pytest.mark.parametrize("kernel", sorted(LAST_CARD_CASES))
def test_kernel_on_the_last_card(dev, monkeypatch, kernel):
    """The kernel's own test at one of its shapes, with every operand on
    cuda:{device_count - 1}."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    LAST_CARD_CASES[kernel](last, monkeypatch)
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == 0


def test_frame_is_the_gathered_frame_on_the_card(dev):
    """The flagship (committed weights and proposal, 64³ occupancy culling,
    K1 and K2) at the bench pose, a 64×64 frame in 512-ray chunks, a
    quarter of which miss the box: bit for bit the frame built by index
    gathers (tests/gathered_frame.py), on the card's own tensors."""
    from gathered_frame import gathered_frame
    from fashion_nerf_torch.bench import bench_pose, bench_setup
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    cfg = load_config("blender_lego", ["render.chunk=512"])
    s = bench_setup(cfg, dev)
    params, occ = s["params"], s["occ"]
    assert occ is not None and "proposal" in params
    focal, c2w = bench_pose(64)
    K.reset_launches()
    with torch.no_grad():
        got = render_image_blockwise(params, cfg, 64, 64, focal, c2w,
                                     occ=occ, device=dev)
        want = gathered_frame(params, cfg, 64, 64, focal, c2w, occ=occ,
                              device=dev)
    torch.cuda.synchronize(dev)
    assert K.LAUNCHES["sigma_march"] > 0 and K.LAUNCHES["slim_march"] > 0
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device == dev and got[k].shape[:2] == (64, 64), k
        assert torch.equal(got[k], want[k]), k
    live = got["chunk_live"]
    assert live.any() and not live.all()


def test_frame_under_plain_versions_launches_nothing(dev):
    """The same 64×64 flagship frame inside `K.plain_versions()`: every
    wrapper takes its plain version on the card's tensors, so no kernel
    launches, and the frame is within 40 dB (chip_smoke.py's bar) of the
    kernels' frame."""
    from fashion_nerf_torch.bench import bench_pose, bench_setup
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    cfg = load_config("blender_lego", ["render.chunk=512"])
    s = bench_setup(cfg, dev)
    focal, c2w = bench_pose(64)

    def frame():
        return render_image_blockwise(s["params"], cfg, 64, 64, focal, c2w,
                                      occ=s["occ"], device=dev)

    K.reset_launches()
    with torch.no_grad():
        kern = frame()
        assert K.LAUNCHES["sigma_march"] > 0 and K.LAUNCHES["box_cull"] > 0
        K.reset_launches()
        with K.plain_versions():
            plain = frame()
    torch.cuda.synchronize(dev)
    assert not any(K.LAUNCHES.values()), K.LAUNCHES
    assert plain["rgb"].device == dev
    assert float(psnr(plain["rgb"], kern["rgb"])) >= 40.0


# --- K8: occupancy culling against the macro boxes --------------------------

def _analytic_occ(macro, dev):
    """Two σ blobs on a 32³ lattice, reduced to macro³ boxes (512 or 4096,
    K8 staging 512 at a time), on the card."""
    from fashion_nerf_torch.core.occupancy import build_occupancy

    def field(p, dirs):
        a = ((p - torch.tensor([0.5, 0.2, -0.3])) ** 2).sum(-1).sqrt() < 0.45
        b = ((p - torch.tensor([-0.9, -0.6, 0.8])) ** 2).sum(-1).sqrt() < 0.3
        return None, torch.where(a | b, 5.0, -1.0)
    occ = build_occupancy(field, -2.0, 2.0, resolution=32,
                          sigma_threshold=0.1, margin_cells=1, macro=macro,
                          chunk=4096)
    return type(occ)(*[x.to(dev) for x in occ])


def _cull_rays(case, occ, R, rng, dev):
    """Rays from radius 4 at the scene (half of them axis-parallel under
    "axis"), from inside occupied boxes ("inside"), or away from it
    ("miss"), unit directions."""
    o = rng.normal(size=(R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.normal(0, 0.6, (R, 3))
    if case == "axis":
        d[: R // 2, 0] = 0.0
        d[R // 4: R // 2, 2] = -0.0
    elif case == "inside":
        c = (0.5 * (occ.boxes_min + occ.boxes_max))[occ.boxes_occ].cpu()
        o = c.numpy()[rng.integers(0, len(c), R)]
        d = rng.normal(size=(R, 3))
    elif case == "miss":
        d = o + rng.normal(0, 0.1, (R, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def _k8_against_plain(o, d, occ, near, far, blocks):
    """K8's box_cull, then block_hit at each (NB, SB, S) of `blocks` on S
    stratified samples between the ray's near and far zero-padded to NB·SB,
    on the occupied boxes (`occupied_boxes`), each torch.equal to its plain
    version and to the composition over all K boxes with their flags, one
    launch each, and no tensor allocated beyond the outputs.
    → (hit, [flags])."""
    from fashion_nerf_torch.core.occupancy import (block_overlap,
                                                   box_segments,
                                                   occupied_boxes,
                                                   ray_multi_aabb)
    from fashion_nerf_torch.core.sampling import stratified_sample
    from fashion_nerf_torch.kernels import boxcull
    from fashion_nerf_torch.render.blockwise import _pass_dists
    R, dev = o.shape[0], o.device
    seg = box_segments(o, d, *occupied_boxes(occ), near, far)
    full = ray_multi_aabb(o, d, occ, near, far)

    def extra_bytes(fn):
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, torch.cuda.max_memory_allocated(dev) - before

    n0 = dict(K.LAUNCHES)
    got, extra = extra_bytes(lambda: boxcull.box_cull(seg))
    assert extra <= 9 * R + 4096, extra             # near, far, hit
    for a, b, c in zip(got, boxcull.box_cull_plain(seg), full):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    flags = []
    for NB, SB, S in blocks:
        t = stratified_sample(got[0], got[1], R, S)
        t_pad, _ = _pass_dists(t, torch.ones((R, 1), device=dev), far, SB)
        assert t_pad.shape == (R, NB * SB)
        f, extra = extra_bytes(lambda: boxcull.block_hit(t_pad, SB, seg))
        assert extra <= 4 * R * NB + 4096, extra
        assert torch.equal(f, boxcull.block_hit_plain(t_pad, SB, seg))
        assert torch.equal(f, block_overlap(t_pad, SB, full[3:], R, NB))
        flags.append(f)
    assert K.LAUNCHES["box_cull"] - n0["box_cull"] == 1
    assert K.LAUNCHES["block_hit"] - n0["block_hit"] == len(blocks)
    return got[2], flags


@pytest.mark.parametrize("case,macro,R,NB,SB", [
    ("axis", 8, 1000, 3, 32), ("inside", 8, 4097, 1, 64),
    ("miss", 8, 256, 3, 32), ("empty", 8, 300, 1, 64),
    ("generic", 16, 5000, 12, 8), ("generic", 16, 777, 5, 1)])
def test_box_cull_kernel_cases(dev, case, macro, R, NB, SB):
    """K8 against its plain versions on the analytic boxes: axis-parallel
    rays (reciprocals at ±1e10), rays from inside a box (near 0), rays
    that miss every box, no box occupied (one box of zero volume), 4096
    boxes (more than one stage of shared memory), ragged R, NB 1 to 12
    (three register groups) and SB 1; the samples' last block zero-padded
    where SB ≥ 4."""
    rng = np.random.default_rng(R)
    occ = _analytic_occ(macro, dev)
    if case == "empty":
        occ = occ._replace(boxes_occ=torch.zeros_like(occ.boxes_occ))
    o, d = _cull_rays(case, occ, R, rng, dev)
    near = 0.0 if case == "inside" else 2.0
    hit, flags = _k8_against_plain(o, d, occ, near, 6.0,
                                   [(NB, SB, NB * SB - SB // 4)])
    n_hit = int(hit.sum())
    if case in ("miss", "empty"):
        assert n_hit == 0 and not flags[0].any()
    elif case == "inside":
        assert n_hit == R
    else:
        assert 0 < n_hit < R and 0 < flags[0].sum() < flags[0].numel()


def test_box_cull_rejects_bad_inputs(dev):
    """K8's wrappers raise on what the kernel does not take, and launch
    nothing."""
    from fashion_nerf_torch.core.occupancy import box_segments, occupied_boxes
    from fashion_nerf_torch.kernels import boxcull
    occ = _analytic_occ(8, dev)
    o, d = _cull_rays("generic", occ, 64, np.random.default_rng(0), dev)
    seg = box_segments(o, d, *occupied_boxes(occ), 2.0, 6.0)
    t = torch.linspace(2.0, 6.0, 96, device=dev).expand(64, 96).contiguous()
    n0 = dict(K.LAUNCHES)
    with pytest.raises(TypeError):
        boxcull.box_cull(seg._replace(rays_o=o.double()))
    with pytest.raises(ValueError):
        boxcull.box_cull(seg._replace(rays_o=o.t().contiguous().t()))
    with pytest.raises(ValueError):
        boxcull.box_cull(seg._replace(rays_o=o.cpu()))
    with pytest.raises(ValueError):
        boxcull.box_cull(seg._replace(lo=seg.lo[:0], hi=seg.hi[:0]))
    with pytest.raises(ValueError):
        boxcull.box_cull(seg._replace(hi=seg.hi[:1]))
    with pytest.raises(ValueError):
        boxcull.block_hit(t[:, :90].contiguous(), 32, seg)
    with pytest.raises(ValueError):
        boxcull.block_hit(t[:, ::2], 16, seg)
    assert dict(K.LAUNCHES) == n0


# the orbit cell (perfbench/traffic/orbit40_800.json): 800×800 frames on a
# circle at φ −30°, radius 4, 65,536-ray chunks
ORBIT_FRAME, ORBIT_FOV_X, ORBIT_CHUNK = 800, 0.6911112070083618, 65536


def _orbit_c2w(theta_deg, phi_deg=-30.0, radius=4.0):
    """(3, 4) camera-to-world at `radius` looking at the origin in the
    flagship scene's z-up frame: from (0, 0, radius) turned by φ about x,
    then by θ about z (the benchmark's orbit)."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(ph), -math.sin(ph), 0],
                        [0, math.sin(ph), math.cos(ph), 0], [0, 0, 0, 1]])
    rot_theta = np.array([[math.cos(th), -math.sin(th), 0, 0],
                          [math.sin(th), math.cos(th), 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]])
    return (rot_theta @ rot_phi @ trans).astype(np.float32)[:3]


@pytest.fixture(scope="module")
def flagship():
    """The committed flagship (weights, proposal, 64³ occupancy swept
    through K3, 512 macro boxes) on cuda:0, at the orbit cell's chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from fashion_nerf_torch.bench import bench_setup
    from fashion_nerf_torch.config import load_config
    cfg = load_config("blender_lego", [f"render.chunk={ORBIT_CHUNK}"])
    s = bench_setup(cfg, torch.device("cuda", 0))
    assert s["occ"] is not None and "proposal" in s["params"]
    assert s["occ"].boxes_occ.numel() == 512
    return cfg, s


@pytest.mark.parametrize("theta", [0.0, 153.0])
def test_box_cull_kernel_at_the_orbit_chunk(dev, flagship, theta):
    """K8 at the orbit cell's shapes: the 65,536-ray chunk of an 800×800
    orbit frame (tile order) with the most rays in the global box, against
    the committed flagship's 512 macro boxes. box_cull's near, far and hit
    and block_hit at NB 1 (the proposal's 64 samples) and NB 3 (96 fine
    samples in blocks of 32) are torch.equal to the plain versions, with
    no tensor allocated beyond their outputs (the plain versions write
    (65,536, n) ones, n the occupied boxes)."""
    from fashion_nerf_torch.core.cameras import generate_rays
    from fashion_nerf_torch.core.occupancy import ray_aabb_intersect
    from fashion_nerf_torch.render.blockwise import _to_tiles
    cfg, s = flagship
    occ, rc = s["occ"], cfg.render
    H = W = ORBIT_FRAME
    focal = 0.5 * W / math.tan(0.5 * ORBIT_FOV_X)
    o, d = generate_rays(H, W, focal, _orbit_c2w(theta), device=dev)
    o, d = (_to_tiles(x.reshape(-1, 3), H, W) for x in (o, d))
    n_box = [int(ray_aabb_intersect(o[c:c + ORBIT_CHUNK],
                                    d[c:c + ORBIT_CHUNK], occ.box_min,
                                    occ.box_max, rc.near, rc.far)[2].sum())
             for c in range(0, H * W - ORBIT_CHUNK + 1, ORBIT_CHUNK)]
    c = ORBIT_CHUNK * int(np.argmax(n_box))
    o, d = o[c:c + ORBIT_CHUNK].contiguous(), d[c:c + ORBIT_CHUNK]
    hit, flags = _k8_against_plain(o, d, occ, rc.near, rc.far,
                                   [(1, 64, 64), (3, 32, 96)])
    assert 0 < int(hit.sum()) < ORBIT_CHUNK
    assert all(0 < f.sum() < f.numel() for f in flags)


def test_orbit_frame_is_the_frame_with_plain_culling(dev, flagship,
                                                     monkeypatch):
    """An 800×800 orbit frame of the flagship in 65,536-ray chunks, culled
    by K8 against the occupied boxes, is bit for bit the frame with K8's
    plain versions in its place, and the frame culled by the composition
    over all 512 boxes with their flags (`ray_multi_aabb_inv`,
    `block_overlap`: what the render ran before K8); K8 launches box_cull
    once and block_hit twice (the proposal's and the fine march's flags) a
    live chunk, and the chunk's culling hands the marches a segment handle,
    not (R, 512) segments."""
    from fashion_nerf_torch.core.occupancy import (BoxSegments,
                                                   block_overlap,
                                                   ray_multi_aabb_inv)
    from fashion_nerf_torch.kernels import boxcull
    from fashion_nerf_torch.render import blockwise
    cfg, s = flagship
    focal = 0.5 * ORBIT_FRAME / math.tan(0.5 * ORBIT_FOV_X)
    c2w = _orbit_c2w(153.0)
    segs = []
    culling = blockwise.culling

    def recording(*a, **kw):
        out = culling(*a, **kw)
        segs.append(out[3])
        return out

    def frame():
        segs.clear()
        K.reset_launches()
        with torch.no_grad():
            out = blockwise.render_image_blockwise(
                s["params"], cfg, ORBIT_FRAME, ORBIT_FRAME, focal, c2w,
                occ=s["occ"], device=dev)
        torch.cuda.synchronize(dev)
        return out, len(segs), dict(K.LAUNCHES)

    monkeypatch.setattr(blockwise, "culling", recording)
    got, n_live, n = frame()
    assert 0 < n_live <= -(-ORBIT_FRAME ** 2 // ORBIT_CHUNK)
    assert all(isinstance(x, BoxSegments) for x in segs)
    assert n["box_cull"] == n_live and n["block_hit"] == 2 * n_live, n
    monkeypatch.setattr(boxcull, "box_cull", boxcull.box_cull_plain)
    monkeypatch.setattr(boxcull, "block_hit", boxcull.block_hit_plain)
    want, n_live_p, n_p = frame()
    assert n_live_p == n_live and n_p["box_cull"] == n_p["block_hit"] == 0
    assert n_p["sigma_march"] == n["sigma_march"] > 0
    occ = s["occ"]

    def all_boxes(seg):
        return ray_multi_aabb_inv(seg.rays_o, seg.inv_d, occ.boxes_min,
                                  occ.boxes_max, seg.near, seg.far,
                                  occ.boxes_occ)

    monkeypatch.setattr(boxcull, "box_cull", lambda seg: all_boxes(seg)[:3])
    monkeypatch.setattr(boxcull, "block_hit", lambda t, SB, seg: block_overlap(
        t, SB, all_boxes(seg)[3:], t.shape[0], t.shape[1] // SB))
    before, n_live_b, _ = frame()
    assert n_live_b == n_live
    for other in (want, before):
        assert got.keys() == other.keys()
        for k in other:
            assert torch.equal(got[k], other[k]), k
