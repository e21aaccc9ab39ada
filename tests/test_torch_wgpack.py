"""The host side of the Hopper marches K1 and K2: the wgmma weight packing
(kernels/wgpack.py) and the wrappers' shape checks, on the CPU."""

import numpy as np
import pytest
import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels import sigmamarch, slimmarch, wgpack
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

torch.set_num_threads(2)


def _net(rng, shapes):
    return load_flax_params({"params": {
        name: {"kernel": rng.normal(size=(i, o)).astype(np.float32),
               "bias": rng.normal(size=o).astype(np.float32)}
        for name, (i, o) in shapes.items()}}, compute_dtype="bfloat16")


def fine(rng, W=256, L=10, depth=8, skip=4):
    cx = 3 * (2 * L + 1)
    shapes = {f"trunk_{i}": ((cx + W) if i == skip + 1 else
                             (cx if i == 0 else W), W) for i in range(depth)}
    shapes.update(sigma_head=(W, 1), feature=(W, W), view_0=(W + 27, W // 2),
                  rgb_head=(W // 2, 3))
    return _net(rng, shapes)


def prop(rng, W=128, L=6, depth=2):
    shapes = {"trunk_0": (3 * (2 * L + 1), W)}
    shapes.update({f"trunk_{i}": (W, W) for i in range(1, depth)})
    shapes["out_head"] = (W, 4)
    return _net(rng, shapes)


def _expected_shapes(net):
    """(kk, N) of every slice, as the kernels' host code lists them
    (csrc/slimmarch.cu, csrc/sigmamarch.cu)."""
    W, out = net.width, []
    for i in range(net.depth):
        if net.lay["w_h"][i] is not None:
            out += [(64, W)] * (W // 64)
        if net.lay["w_a0"][i] is not None:
            out.append((net.k0, W))
    if net.has_vd:
        out += [(64, W)] * (W // 64) + [(64, W // 2)] * (W // 64)
    return out


@pytest.mark.parametrize("which", ["fine", "fine_d4", "proposal",
                                   "proposal_d3"])
def test_unpack_returns_every_layer_exactly(which):
    """A plain unpack of the packed buffer returns every layer's kernel,
    bitwise, in the order the kernels consume them."""
    rng = np.random.default_rng(0)
    if which.startswith("fine"):
        net = slimmarch.split_hoist(
            fine(rng) if which == "fine" else fine(rng, depth=4, skip=1))
    else:
        net = sigmamarch.pack_sigma(
            prop(rng) if which == "proposal" else prop(rng, depth=3))
    shapes = _expected_shapes(net)
    ref = wgpack.march_slices(net)
    assert [tuple(k.shape) for k in ref] == shapes
    buf = wgpack.pack_slices(net)
    assert buf.dtype == torch.bfloat16 and buf.numel() == sum(
        kk * n for kk, n in shapes)
    for got, want in zip(wgpack.unpack_slices(buf, shapes), ref):
        assert torch.equal(got, want)
    lay, W = net.lay, net.width
    layer0 = net.w[lay["w_a0"][0]:lay["w_a0"][0] + net.k0 * W].view(
        net.k0, W)
    k_a0 = [k for k in ref if k.shape[0] == net.k0 and k.shape[1] == W]
    assert torch.equal(k_a0[0], layer0)


def test_tile_layout_of_one_core_matrix():
    """Element (k, n) of a slice of kk rows sits at (n//8)·kk·8 +
    (k//8)·64 + (n%8)·8 + k%8: the K-major core-matrix layout."""
    kk, N = 32, 24
    k = torch.arange(kk * N, dtype=torch.float32).view(kk, N)
    flat = wgpack._tile(k)
    for kr, n in ((0, 0), (5, 3), (9, 17), (31, 23), (16, 8)):
        off = (n // 8) * kk * 8 + (kr // 8) * 64 + (n % 8) * 8 + kr % 8
        assert float(flat[off]) == float(k[kr, n])


def test_march_buffer_is_built_once():
    rng = np.random.default_rng(1)
    net = sigmamarch.pack_sigma(prop(rng))
    assert net.wg is None
    a = wgpack.march_buffer(net)
    assert wgpack.march_buffer(net) is a and net.wg is a
    assert a.numel() == 48 * 128 + 128 * 128


@pytest.mark.parametrize("R,SB,width,ok", [
    (64, 32, 256, True), (0, 32, 256, True), (32, 64, 128, True),
    (128, 16, 256, True), (64, 32, 128, False), (64, 8, 256, False),
    (16, 128, 256, True), (96, 32, 256, False), (340, 24, 256, False),
    (8, 1024, 256, False), (1025 * 64, 32, 256, True),
    (1024 * 64, 32, 256, True)])
def test_check_march_shape(R, SB, width, ok):
    """The reference's SBs (not 24 or 1024), whole tiles and the kernel's
    width; any number of tiles (the wrappers launch per MARCH_MAX_TILES);
    R = 0 passes."""
    if ok:
        sigmamarch.check_march_shape(R, SB, width, width if width in (
            K.SIGMA_WIDTH, K.SLIM_WIDTH) else 0)
    else:
        with pytest.raises(ValueError):
            sigmamarch.check_march_shape(R, SB, width, K.SLIM_WIDTH)


def test_plain_versions_keep_any_block_size_on_cpu():
    """The shape rules are the kernels': on CPU tensors the wrappers take
    the plain versions at SB = 8 as well, and count no launch."""
    rng = np.random.default_rng(2)
    K.reset_launches()
    net = sigmamarch.pack_sigma(prop(rng, W=32, L=2))
    R, SB = 256, 8
    ro, rd = torch.zeros(R, 3), torch.tensor(rng.normal(size=(R, 3)),
                                             dtype=torch.float32)
    hz = sigmamarch.hoist_rays(net, ro, rd)
    t = torch.linspace(0.1, 2.0, SB).expand(R, SB).contiguous()
    d = torch.full((R, SB), 0.1)
    out = sigmamarch.sigma_march(net, hz, torch.ones(R), t, d)
    ref = sigmamarch.sigma_march_plain(net, hz, torch.ones(R), t, d)
    # two CPU runs of the same f32 matmul chain: a loaded BLAS may split
    # its sums differently from one call to the next, so the last bit may
    # differ
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert K.LAUNCHES["sigma_march"] == 0 and net.wg is None
