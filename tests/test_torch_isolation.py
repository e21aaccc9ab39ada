"""The port stands alone: it imports no JAX, its kernel wrappers take the
plain versions on CPU tensors without counting a launch, and its GPU entry
points refuse to run without a CUDA device."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fashion_nerf_torch
from fashion_nerf_torch import bench
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch import probe, quality
from fashion_nerf_torch.core.occupancy import box_segments
from fashion_nerf_torch.kernels import (boxcull, carrymarch, posenc_mlp,
                                        render, sigmamarch, slimmarch)
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP, load_flax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        fashion_nerf_torch.__path__, "fashion_nerf_torch."))


def test_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke, imports with `jax` and the
    JAX package `fashion_nerf` unimportable (sys.modules[...] = None), and
    no `jax` or `fashion_nerf` module gets loaded."""
    mods = _modules()
    for m in ("render.blockwise", "render.renderer", "kernels.render",
              "train.loop", "train.state", "data.synthetic", "data.pipeline",
              "ckpt", "cli", "prng", "kernels.carrymarch", "quality",
              "probe", "config", "assets", "kernels.wgpack", "parity", "png",
              "models.proposal", "tryon.matcher", "__main__"):
        assert f"fashion_nerf_torch.{m}" in mods, m
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['fashion_nerf'] = None; "
            f"sys.path[:0] = [{SRC!r}, {ROOT!r}]; import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "import chip_smoke; "
            "bad = [k for k, v in sys.modules.items() if v is not None and "
            "(k in ('jax', 'fashion_nerf') or k.startswith('jax.') or "
            "k.startswith('fashion_nerf.'))]; "
            "assert not bad, bad; "
            "print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _tree(rng, shapes):
    return {"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32),
            "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
        for name, (i, o) in shapes.items()}}


def small_fine(rng, W=32, L=3):
    """A 4-layer view-branch field with a skip after layer 1."""
    cx, cd = 3 * (2 * L + 1), 3 * (2 * 2 + 1)
    return load_flax_params(_tree(rng, {
        "trunk_0": (cx, W), "trunk_1": (W, W), "trunk_2": (cx + W, W),
        "trunk_3": (W, W), "sigma_head": (W, 1), "feature": (W, W),
        "view_0": (W + cd, W // 2), "rgb_head": (W // 2, 3)}),
        compute_dtype="bfloat16")


def small_prop(rng, W=32, L=3):
    cx = 3 * (2 * L + 1)
    return load_flax_params(_tree(rng, {
        "trunk_0": (cx, W), "trunk_1": (W, W), "out_head": (W, 4)}),
        compute_dtype="bfloat16")


def _randn(rng, *shape):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32)


def test_wrappers_take_plain_on_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    leaves its launch counter at 0."""
    rng = np.random.default_rng(0)
    K.reset_launches()
    fine, prop = small_fine(rng), small_prop(rng)
    assert fine.skips == (1,) and isinstance(prop, NeRFMLP)

    net = posenc_mlp.pack_params(fine, hoist_x=False)
    pts = torch.tensor(rng.uniform(-1, 1, (128, 3)), dtype=torch.float32)
    dp = posenc_mlp.hoist_dirs(net, _randn(rng, 2, 3))
    a = posenc_mlp.field_rows(net, pts, dp, 64)
    b = posenc_mlp.field_rows_plain(net, pts, dp, 64)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    pts2 = torch.tensor(rng.uniform(-1, 1, (4096, 3)), dtype=torch.float32)
    dp2 = posenc_mlp.hoist_dirs(net, _randn(rng, 64, 3))
    alive = torch.tensor([1.0, 0.0])
    for x, y in zip(posenc_mlp.field_rows(net, pts2, dp2, 64, alive=alive),
                    posenc_mlp.field_rows_plain(net, pts2, dp2, 64,
                                                alive=alive)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    R, SB = 32, 64
    snet = sigmamarch.pack_sigma(prop)
    ro, rd = torch.zeros(R, 3), _randn(rng, R, 3)
    hz = sigmamarch.hoist_rays(snet, ro, rd)
    t = torch.linspace(0.1, 2.0, SB).expand(R, SB).contiguous()
    d = torch.full((R, SB), 0.03)
    alive = torch.ones(R)
    for x, y in zip(sigmamarch.sigma_march(snet, hz, alive, t, d),
                    sigmamarch.sigma_march_plain(snet, hz, alive, t, d)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    R, NB, SB = 64, 2, 32
    fnet = slimmarch.split_hoist(fine)
    ro, rd = torch.zeros(R, 3), _randn(rng, R, 3)
    hf = slimmarch.hoist_rays(fnet, ro, rd)
    dpf = posenc_mlp.hoist_dirs(fnet, rd)
    t = torch.linspace(0.1, 2.0, NB * SB).expand(R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 0.03)
    args = (fnet, hf, dpf, torch.ones(R), torch.ones(R, NB), t, d, -6.9)
    for x, y in zip(slimmarch.slim_march(*args),
                    slimmarch.slim_march_plain(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    pnet = slimmarch.split_hoist(prop)
    args = (pnet, slimmarch.hoist_rays(pnet, ro, rd), None, torch.ones(R),
            torch.ones(R, NB), t, d, -6.9)
    for x, y in zip(slimmarch.slim_march(*args),
                    slimmarch.slim_march_plain(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    g_rgb, g_sig = _randn(rng, 128, 3), _randn(rng, 128)
    for x, y in zip(
            posenc_mlp.field_rows_backward(net, pts, dp, g_rgb, g_sig, 64),
            posenc_mlp.field_rows_backward_plain(net, pts, dp, g_rgb, g_sig,
                                                 64)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    cfine = load_flax_params(_tree(rng, {
        "trunk_0": (21 + 8, 32), "trunk_1": (32, 32),
        "trunk_2": (21 + 8 + 32, 32), "sigma_head": (32, 1),
        "feature": (32, 32), "view_0": (32 + 27, 16), "rgb_head": (16, 3)}),
        compute_dtype="bfloat16", cond_dim=8)
    cnet = posenc_mlp.pack_params(cfine, hoist_x=False)
    cdp = posenc_mlp.hoist_dirs(cnet, _randn(rng, 2, 3))
    cp = posenc_mlp.hoist_cond(cnet, _randn(rng, 2, 8))
    got = posenc_mlp.field_rows_backward(cnet, pts, cdp, g_rgb, g_sig, 64, cp)
    want = posenc_mlp.field_rows_backward_plain(cnet, pts, cdp, g_rgb, g_sig,
                                                64, cp)
    assert len(got) == len(want) == 5
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    R, S = 16, 24
    vr = (torch.rand(R, S, 3), _randn(rng, R, S),
          torch.sort(torch.rand(R, S) * 4 + 2, dim=1).values,
          torch.rand(R) + 0.5, True)
    for x, y in zip(render.volrend(*vr), render.volrend_plain(*vr)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    ro = torch.full((R, 3), 3.0)
    seg = box_segments(ro, -ro + 0.3 * _randn(rng, R, 3),
                       torch.tensor([[-1.0, -1, -1], [0, 0, 0]]),
                       torch.tensor([[0.0, 0, 0], [1, 1, 1]]), 2.0, 6.0)
    for x, y in zip(boxcull.box_cull(seg), boxcull.box_cull_plain(seg)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    t = vr[2].contiguous()
    torch.testing.assert_close(boxcull.block_hit(t, 8, seg),
                               boxcull.block_hit_plain(t, 8, seg),
                               rtol=0, atol=0)

    R, NB, SB = 64, 2, 32
    cnet = posenc_mlp.pack_params(fine, hoist_x=False)
    ro, rd = torch.zeros(R, 3), _randn(rng, R, 3)
    t = torch.linspace(0.1, 2.0, NB * SB).expand(R, NB * SB).contiguous()
    d = torch.full((R, NB * SB), 0.03)
    args = (cnet, posenc_mlp.hoist_dirs(cnet, rd), ro, rd, torch.ones(R),
            torch.ones(R, NB), t, d, -6.9)
    for x, y in zip(carrymarch.carry_march(*args),
                    carrymarch.carry_march_plain(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    x, ws = probe.make_inputs(128, 32, 3, 0.06, 0, torch.device("cpu"))
    for mode in probe.MODES:
        torch.testing.assert_close(probe.tc_chain(x, ws, mode, True),
                                   probe.tc_chain_plain(x, ws, mode, True),
                                   rtol=0, atol=0)
    assert set(K.LAUNCHES) == {"field", "sigma_march", "slim_march",
                               "field_bwd", "volrend", "carry_march",
                               "probe_p1", "probe_p2", "field_cond",
                               "slim_march_cond", "carry_march_cond",
                               "field_bwd_cond", "field_alive",
                               "slim_march_novd", "sigma_march_k2",
                               "sigma_march_sb", "slim_march_sb",
                               "carry_march_sb", "wide_field",
                               "wide_field_bwd", "box_cull", "block_hit"}
    assert not any(K.LAUNCHES.values())


def test_run_bench_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from fashion_nerf_torch.config import load_config
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_bench(load_config("blender_lego"))


def test_gate_and_probe_without_cuda_raise(monkeypatch):
    """The gate and the probe measure the card: without one they raise
    unless the CPU is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quality.run_gate()
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run_p1(K.resolve_device(None))
    assert K.resolve_device("cpu") == torch.device("cpu")


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    """A failing nvcc raises with its output; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(K, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        K.build()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result here (no CUDA),
    in the repo and as a lone copy in an empty directory."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
