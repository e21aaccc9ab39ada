"""The host side of the wgmma field kernels K3 and K4: their weight packing
(kernels/wgpack.py: the field slices, the transposed slices K4's dgrad
takes, the one-gather build) and their shape rule, on the CPU."""

import numpy as np
import pytest
import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels import (posenc_mlp, sigmamarch, slimmarch,
                                        wgpack)
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

torch.set_num_threads(2)


def _net(rng, shapes):
    return load_flax_params({"params": {
        name: {"kernel": rng.normal(size=(i, o)).astype(np.float32),
               "bias": rng.normal(size=o).astype(np.float32)}
        for name, (i, o) in shapes.items()}}, compute_dtype="bfloat16")


def _model(rng, which):
    """8×256 L=10 with the view branch; 4×256 L=6 without it (skip after
    layer 1); the 2×128 L=6 proposal shape."""
    if which == "fine":
        W, L, depth, skip = 256, 10, 8, 4
    elif which == "noview":
        W, L, depth, skip = 256, 6, 4, 1
    else:
        W, L, depth, skip = 128, 6, 2, None
    cx = 3 * (2 * L + 1)
    shapes = {f"trunk_{i}": ((cx + W) if skip is not None and i == skip + 1
                             else (cx if i == 0 else W), W)
              for i in range(depth)}
    if which == "fine":
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
    else:
        shapes["out_head"] = (W, 4)
    return _net(rng, shapes)


def _field_net(which, seed=0):
    with torch.no_grad():
        return posenc_mlp.pack_params(
            _model(np.random.default_rng(seed), which), hoist_x=False)


def _shapes(net, transposed):
    """(kk, N) of every slice as csrc/wg_field.cuh::field_slice_bytes lists
    them."""
    W, k0, lay, out = net.width, net.k0, net.lay, []
    cut = lambda rows, cols: [(min(64, rows - k), cols)  # noqa: E731
                              for k in range(0, rows, 64)]
    for i in range(net.depth):
        if lay["w_h"][i] is not None:
            out += cut(W, W)
        if lay["w_a0"][i] is not None:
            out += cut(k0, W)
    if net.has_vd:
        out += cut(W, W) + cut(W, W // 2)
    if transposed:
        if net.has_vd:
            out += cut(W // 2, W) + cut(W, W)
        for i in reversed(range(net.depth)):
            if lay["w_a0"][i] is not None:
                out += cut(W, k0)
            if lay["w_h"][i] is not None:
                out += cut(W, W)
    return out


@pytest.mark.parametrize("which,k0", [("fine", 64), ("noview", 48),
                                      ("proposal", 48)])
def test_field_and_transposed_slices_round_trip(which, k0):
    """unpack_slices of the packed buffer returns every forward slice and
    every transposed slice bitwise, in the kernels' order; each transposed
    slice is rows of a layer's Wᵀ."""
    net = _field_net(which)
    assert net.x_rows and net.k0 == k0
    fwd, tr = wgpack.march_slices(net), wgpack.field_slices_t(net)
    assert [tuple(k.shape) for k in fwd + tr] == _shapes(net, True)
    buf = wgpack.pack_slices(net, transposed=True)
    assert buf.dtype == torch.bfloat16
    got = wgpack.unpack_slices(buf, _shapes(net, True))
    for a, b in zip(got, fwd + tr):
        assert torch.equal(a, b)
    lay, W = net.lay, net.width
    a0 = net.w[lay["w_a0"][0]:lay["w_a0"][0] + k0 * W].view(k0, W)
    assert torch.equal(fwd[0 if lay["w_h"][0] is None else -1], a0)
    # the last transposed slices are layer 0's posenc kernel, transposed
    assert torch.equal(torch.cat(tr[-(W // 64):]), a0.t())
    h1 = net.w[lay["w_h"][1]:lay["w_h"][1] + W * W].view(W, W)
    n0 = W // 64 if lay["w_a0"][1] is None else 2 * (W // 64)
    assert torch.equal(torch.cat(tr[-(W // 64) - n0:-(W // 64)])[-W:],
                       h1.t())


@pytest.mark.parametrize("which", ["fine", "noview", "proposal"])
@pytest.mark.parametrize("transposed", [False, True])
def test_gather_equals_reference_packing(which, transposed):
    """The one-gather buffer equals the per-slice reference packing
    bitwise, and the index is built once per layout."""
    net = _field_net(which, seed=1)
    want = wgpack.pack_slices(net, transposed=transposed)
    got = wgpack.field_buffer(net, transposed=transposed)
    assert torch.equal(got, want)
    assert wgpack.field_buffer(net, transposed=transposed) is got
    other = _field_net(which, seed=2)
    idx = wgpack.gather_index(net, transposed, net.w.device)
    assert wgpack.gather_index(other, transposed, other.w.device) is idx
    assert torch.equal(wgpack.gather(other, transposed),
                       wgpack.pack_slices(other, transposed=transposed))


@pytest.mark.parametrize("which", ["march_fine", "march_proposal"])
def test_march_buffer_gather_equals_reference(which):
    rng = np.random.default_rng(3)
    if which == "march_fine":
        net = slimmarch.split_hoist(_model(rng, "fine"))
    else:
        net = sigmamarch.pack_sigma(_model(rng, "proposal"))
    assert torch.equal(wgpack.march_buffer(net), wgpack.pack_slices(net))


@pytest.mark.parametrize("n,spr,width,depth,k0,ok", [
    (4096, 64, 256, 8, 64, True), (4160, 64, 256, 8, 64, True),
    (1088, 1, 256, 8, 64, True), (3072, 192, 256, 8, 64, True),
    (2048, 64, 128, 2, 48, True), (0, 1, 128, 2, 48, True),
    (3072, 96, 128, 4, 64, True), (64 * 7, 7, 256, 8, 48, True),
    (4096, 64, 64, 8, 64, False), (4096, 64, 512, 8, 64, False),
    (4096, 64, 192, 8, 64, False), (4096, 64, 256, 1, 64, False),
    (4096, 64, 256, 9, 64, False), (4096, 64, 256, 8, 32, False),
    (4096 + 32, 1, 256, 8, 64, False), (4160, 128, 256, 8, 64, False),
    (4096, 0, 256, 8, 64, False), (-64, 1, 256, 8, 64, False)])
def test_check_field_shape(n, spr, width, depth, k0, ok):
    """Widths 128 and 256, depth 2-8, k0 48 or 64, n ≡ 0 or 64 (mod 128)
    and a multiple of any spr ≥ 1; anything else raises ValueError. Needs
    no device."""
    if ok:
        posenc_mlp.check_field_shape(n, spr, width, depth, k0)
    else:
        with pytest.raises(ValueError):
            posenc_mlp.check_field_shape(n, spr, width, depth, k0)


def test_field_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors K3's and K4's wrappers take the plain versions at any
    row count, build no wgmma buffer and count no launch."""
    net = _field_net("proposal", seed=4)
    rng = np.random.default_rng(4)
    n, spr = 96, 3
    pts = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
    dp = torch.zeros((n // spr, 64), dtype=torch.bfloat16)
    K.reset_launches()
    rgb, sigma = posenc_mlp.field_rows(net, pts, dp, spr)
    g = posenc_mlp.field_rows_backward(net, pts, dp, torch.ones(n, 3),
                                       torch.ones(n), spr)
    assert rgb.shape == (n, 3) and sigma.shape == (n,) and len(g) == 4
    assert K.LAUNCHES["field"] == K.LAUNCHES["field_bwd"] == 0
    assert net.wg is None and net.wgt is None
