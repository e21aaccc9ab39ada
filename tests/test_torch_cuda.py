"""The port's CUDA kernels against their plain versions on the card, at
small shapes and edge cases (all-dead launches, culled rays in live tiles,
rejected inputs). Marked `cuda`: skipped where no CUDA device is present.

This file imports no JAX, so it also runs on a GPU host without JAX:
    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
(`--noconftest` skips tests/conftest.py, which imports JAX.)"""

import math

import numpy as np
import pytest
import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.kernels import posenc_mlp, sigmamarch, slimmarch
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


def test_field_kernel(dev):
    """Random net: rgb atol 5e-3, σ within 2e-2·(1+|σ|), every row."""
    rng = np.random.default_rng(0)
    net = posenc_mlp.pack_params(fine_net(rng).to(dev), hoist_x=False)
    pts = _f32(rng, 4096, 3, lo=-1.2, hi=1.2, dev=dev)
    dp = posenc_mlp.hoist_dirs(net, _f32(rng, 64, 3, dev=dev)).contiguous()
    n0 = K.LAUNCHES["field"]
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, 64)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, 64)
    assert K.LAUNCHES["field"] == n0 + 1
    _close(rgb_k, rgb_p, 5e-3)
    assert bool(((sig_k - sig_p).abs() <= 2e-2 * (1 + sig_p.abs())).all())


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
