"""Padding of small nets to the shapes the field kernels take
(kernels/posenc_mlp.py: `pad_target`, `pad_packed`, `kernel_net`), on the
CPU through the plain versions of K3 and K4.

A padded net has zero weight rows and columns and zero biases, so it
computes the same function as the net it pads: every sum gains only +0.0
terms. The comparisons here are not bitwise all the same: the CPU's BLAS
blocks a product by its shape, so the same nonzero terms of a sum over 128
columns may be added in another order than over 32. Outputs are held to
1e-6 absolute and gradients, cut back to the unpadded layout, to 1e-6
relative RMS. One case goes through the JAX reference's fused field in
interpret mode at width 32, depth 3, L = 4, at the tolerance
tests/test_torch_kernels_plain.py holds K3's plain version to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.kernels.posenc_mlp_pallas import make_fused_field as j_mff
from fashion_nerf.models.nerf_mlp import init_field as j_init_field
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels import posenc_mlp
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

torch.set_num_threads(2)

# (width, depth, L, view branch, layer that takes the skip or None)
NETS = [(16, 3, 2, True, None), (16, 4, 4, False, 2), (32, 3, 4, True, None),
        (32, 4, 6, True, 2), (32, 3, 2, False, None), (64, 3, 6, True, None),
        (64, 4, 4, True, 2), (64, 4, 2, False, 2), (64, 3, 4, False, None)]


def _model(rng, W, depth, L, vd, skip):
    cx = 3 * (2 * L + 1)
    shapes = {f"trunk_{i}": ((cx + W) if i == skip else (cx if i == 0 else W),
                             W) for i in range(depth)}
    if vd:
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
    else:
        shapes["out_head"] = (W, 4)
    return load_flax_params({"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32),
            "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
        for name, (i, o) in shapes.items()}}, compute_dtype="bfloat16")


def _case(W, depth, L, vd, skip, n=192, spr=3):
    rng = np.random.default_rng(W * 100 + depth * 10 + L)
    with torch.no_grad():
        net = posenc_mlp.pack_params(_model(rng, W, depth, L, vd, skip),
                                     hoist_x=False)
    big = posenc_mlp.pad_packed(net)
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (n, 3)), dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(n // spr, 3)), dtype=torch.float32)
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    return rng, net, big, pts, dp, posenc_mlp.pad_dirpart(net, big, dp), spr


def _rel_rms(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("W,depth,L,vd,skip", NETS)
def test_padded_forward_equals_unpadded(W, depth, L, vd, skip):
    """Plain K3 on the padded net against the same on the unpadded net:
    rgb and σ within 1e-6 on every row; the padded net has a shape the
    kernels take and keeps the unpadded entries where `unpad` says."""
    _, net, big, pts, dp, dp_big, spr = _case(W, depth, L, vd, skip)
    assert (big.width, big.k0) == (128, 48) and big.depth == depth
    posenc_mlp.check_field_shape(pts.shape[0] // 64 * 64, 1, big.width,
                                 big.depth, big.k0)
    pos_w, pos_b = big.unpad
    assert torch.equal(big.w[pos_w], net.w)
    assert torch.equal(big.b[pos_b], net.b)
    assert int((big.w != 0).sum()) == int((net.w != 0).sum())
    assert bool(net.skips) == (skip is not None)
    with torch.no_grad():
        rgb, sig = posenc_mlp.field_rows_plain(net, pts, dp, spr)
        rgb_b, sig_b = posenc_mlp.field_rows_plain(big, pts, dp_big, spr)
    assert float((rgb - rgb_b).abs().max()) <= 1e-6
    assert float((sig - sig_b).abs().max()) <= 1e-6 * (1 + float(
        sig.abs().max()))


@pytest.mark.parametrize("W,depth,L,vd,skip", NETS)
def test_padded_backward_cut_back_equals_unpadded(W, depth, L, vd, skip):
    """Plain K4 on the padded net, its d_w, d_b and d_dirpart cut back to
    the unpadded layout, against the same on the unpadded net: 1e-6
    relative RMS each; the padding's own gradients are exact zeros."""
    rng, net, big, pts, dp, dp_big, spr = _case(W, depth, L, vd, skip)
    n = pts.shape[0]
    g_rgb = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    g_sig = torch.tensor(rng.normal(size=n), dtype=torch.float32)
    with torch.no_grad():
        want = posenc_mlp.field_rows_backward_plain(net, pts, dp, g_rgb,
                                                    g_sig, spr)
        d_pts, d_dir, d_w, d_b = posenc_mlp.field_rows_backward_plain(
            big, pts, dp_big, g_rgb, g_sig, spr)
    pos_w, pos_b = big.unpad
    got = (d_pts, d_dir[:, :dp.shape[1]], d_w[pos_w], d_b[pos_b])
    for name, a, b in zip(("d_pts", "d_dir", "d_w", "d_b"), got, want):
        assert a.shape == b.shape, name
        if name == "d_dir" and not vd:
            assert bool((a == 0).all())
            continue
        assert _rel_rms(a, b) <= 1e-6, (name, _rel_rms(a, b))
    pad_w = torch.ones_like(d_w, dtype=torch.bool)
    pad_w[pos_w] = False
    assert bool((d_w[pad_w] == 0).all())
    if vd:
        assert bool((d_dir[:, dp.shape[1]:] == 0).all())


@pytest.mark.parametrize("width,depth,k0,why", [
    (512, 8, 64, "width"), (64, 9, 64, "depth"), (64, 1, 48, "depth"),
    (64, 3, 80, "posenc")])
def test_pad_target_refuses(width, depth, k0, why):
    """A net wider than 256, deeper than 8, of depth 1, or with L = 12
    (3 + 6L > 64) cannot be padded: ValueError naming why."""
    with pytest.raises(ValueError, match=why):
        posenc_mlp.pad_target(width, depth, k0)


@pytest.mark.parametrize("width,depth,k0,want", [
    (16, 3, 16, (128, 48)), (32, 3, 32, (128, 48)), (64, 8, 64, (128, 64)),
    (128, 2, 48, (128, 48)), (160, 4, 48, (256, 48)), (256, 8, 64, (256, 64)),
    (128, 4, 32, (128, 48))])
def test_pad_target(width, depth, k0, want):
    assert posenc_mlp.pad_target(width, depth, k0) == want


def test_kernel_net_pads_once_and_leaves_kernel_shapes():
    """`kernel_net` returns a net of a kernel shape as it is, pads another
    once and keeps the result on the net."""
    rng = np.random.default_rng(0)
    with torch.no_grad():
        small = posenc_mlp.pack_params(_model(rng, 32, 3, 4, True, None),
                                       hoist_x=False)
        full = posenc_mlp.pack_params(_model(rng, 128, 2, 6, False, None),
                                      hoist_x=False)
        marched = posenc_mlp.pack_params(_model(rng, 32, 3, 4, True, None),
                                         hoist_x=True)
    assert posenc_mlp.kernel_net(full) is full and full.padded is None
    big = posenc_mlp.kernel_net(small)
    assert big.width in K.FIELD_WIDTHS and big.k0 in K.FIELD_K0
    assert posenc_mlp.kernel_net(small) is big
    with pytest.raises(ValueError, match="hoist_x"):
        posenc_mlp.pad_packed(marched)


def test_padded_plain_matches_reference_fused_field():
    """Width 32, depth 3, L = 4 through the reference's fused field in
    interpret mode (tests/kernels/test_posenc_mlp.py's small net) and
    through the port's plain K3 on the padded net: rgb 5e-3 on every row,
    σ within 2e-2·(1 + |σ|)."""
    cfg = load_config("blender_lego", [
        "kernels.interpret=true", "model.net_depth=3", "model.net_width=32",
        "model.posenc_xyz=4"])
    tree = j_init_field(jax.random.PRNGKey(3), cfg.model)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.2, 1.2, (16, 64, 3)).astype(np.float32)
    dirs = rng.normal(size=(16, 3)).astype(np.float32)
    rgb_j, sig_j = j_mff(cfg)(tree, jnp.asarray(pts), jnp.asarray(dirs), None)
    model = load_flax_params(jax.device_get(tree), compute_dtype="bfloat16")
    with torch.no_grad():
        net = posenc_mlp.pack_params(model, hoist_x=False)
        big = posenc_mlp.kernel_net(net)
        assert big is not net and (big.width, big.k0) == (128, 48)
        dp = posenc_mlp.hoist_dirs(net, torch.from_numpy(dirs)).contiguous()
        rgb_t, sig_t = posenc_mlp.field_rows_plain(
            big, torch.from_numpy(pts).reshape(-1, 3),
            posenc_mlp.pad_dirpart(net, big, dp), 64)
    rgb_j = np.asarray(rgb_j).reshape(-1, 3)
    sig_j = np.asarray(sig_j).reshape(-1)
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=5e-3)
    assert np.all(np.abs(sig_t.numpy() - sig_j) <= 2e-2 * (1 + np.abs(sig_j)))
