"""The port's 7-pose quality gate (fashion_nerf_torch.quality) against the
reference's formulas (scripts/quality_check.py --gate): the analytic field
against `field_jnp`, the poses against `look_at`/`ring`, the ground-truth
strips against the same jnp math, and `run_gate` end to end at 16×16 on
the plain versions."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.data.synthetic import field_jnp
from fashion_nerf_torch import bench, quality
from fashion_nerf_torch.data.synthetic import field_torch

torch.set_num_threads(2)

SCENE = {"scale": 0.5, "sharp": 80.0, "texture": 0.6}   # the flagship's


def test_field_torch_matches_field_jnp():
    """Random points over the scene's box, texture on: rtol 1e-5."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, (4096, 3)).astype(np.float32)
    rgb_j, sig_j = field_jnp(jnp.asarray(pts), **SCENE)
    rgb_t, sig_t = field_torch(torch.tensor(pts), **SCENE)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5,
                               atol=1e-6)
    assert float(sig_t.max()) > 10.0 and float(sig_t.min()) < 1e-3


def _look_at(eye):
    """scripts/quality_check.py:69-78, verbatim."""
    eye = np.asarray(eye, np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)[:3]
    m[:, 0], m[:, 1], m[:, 2], m[:, 3] = right, up, -fwd, eye
    return m


def _ring(az_deg, el_deg, r):
    """scripts/quality_check.py:80-84, verbatim."""
    az, el = math.radians(az_deg), math.radians(el_deg)
    return _look_at([r * math.cos(el) * math.sin(az),
                     r * math.sin(el),
                     r * math.cos(el) * math.cos(az)])


def test_poses_match_reference_formulas():
    """The seven poses of quality_check.py:90-103, atol 1e-6."""
    want = [np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]],
                     np.float32),
            _ring(30, 10, 4.0), _ring(-45, 20, 3.2), _ring(120, 35, 5.0),
            _ring(200, -15, 4.5), _ring(60, 25, 2.6), _ring(10, 75, 4.0)]
    assert len(quality.POSES) == 7
    for (_, got), w in zip(quality.POSES, want):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)
    assert quality.POSES[2][0] == "az-45 el20 r3.2 (near)"


def _gt_jnp(pose, H, W, focal, t, near=2.0, far=6.0):
    """The strip math of quality_check.py:120-143 on the whole frame, at
    sample positions t (the reference's jnp.linspace(near, far, n))."""
    n = t.shape[0]
    c2w = jnp.asarray(pose)
    i = jnp.arange(W, dtype=jnp.float32)[None, :]
    j = jnp.arange(H, dtype=jnp.float32)[:, None]
    dirs = jnp.stack([jnp.broadcast_to((i - W * .5) / focal, (H, W)),
                      jnp.broadcast_to(-(j - H * .5) / focal, (H, W)),
                      -jnp.ones((H, W), jnp.float32)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = jnp.broadcast_to(c2w[:3, -1], rays_d.shape)
    t = jnp.asarray(t)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    rgb, sigma = field_jnp(pts, **SCENE)
    delta = (far - near) / (n - 1) * jnp.linalg.norm(rays_d, axis=-1,
                                                     keepdims=True)
    alpha = 1.0 - jnp.exp(-sigma * delta)
    trans = jnp.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = jnp.concatenate([jnp.ones_like(trans[..., :1]), trans[..., :-1]],
                            -1)
    w = alpha * trans
    img = (w[..., None] * rgb).sum(-2) + (1.0 - w.sum(-1)[..., None])
    return np.asarray(jnp.clip(img, 0, 1))


@pytest.mark.parametrize("pose", [0, 2])
def test_gt_render_matches_reference_math(pose):
    """16×16 at 64 samples, in strips of 5 rows (a ragged last strip):
    atol 1e-5 at the same sample positions, and the object is in the
    frame. torch.linspace and jnp.linspace place the samples within one
    f32 ulp of each other (they round differently)."""
    focal, _ = bench.bench_pose(16)
    t = torch.linspace(2.0, 6.0, 64).numpy()
    np.testing.assert_allclose(
        t, np.asarray(jnp.linspace(2.0, 6.0, 64, dtype=jnp.float32)),
        rtol=0, atol=4.8e-7)
    want = _gt_jnp(quality.POSES[pose][1], 16, 16, focal, t)
    got = quality.gt_render(quality.POSES[pose][1], 16, 16, focal, SCENE,
                            n_samples=64, strip=5).numpy()
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.min() < 0.5 and got.max() == 1.0


@pytest.fixture(scope="module")
def gates():
    """run_gate at 16×16 over poses 0 and 5 for both marches (plain
    versions on the CPU), sharing the GT and dense references."""
    cache = {}
    out = {}
    for hoist in ("true", "false"):
        out[hoist] = quality.run_gate(
            ["occupancy.resolution=32", f"kernels.carry_hoist={hoist}"],
            poses=[0, 5], device="cpu", H=16, W=16, cache=cache,
            log=lambda _m: None)
    return out, cache


def test_run_gate_returns_a_finite_table(gates):
    out, cache = gates
    assert sorted(cache) == [(0, 16, 16), (5, 16, 16)]
    for res in out.values():
        rows = res["rows"]
        assert [r["pose"] for r in rows] == [0, 5]
        for r in rows:
            for k in ("dense_vs_gt", "prod_vs_gt", "delta", "mrays"):
                assert math.isfinite(r[k]), (k, r[k])
            assert r["delta"] == pytest.approx(r["prod_vs_gt"]
                                               - r["dense_vs_gt"])
            assert r["image"].shape == (16, 16, 3)
        assert res["worst"] == min(r["delta"] for r in rows)
        assert res["ok"] == (res["worst"] > quality.GATE_DB)
        assert res["worst_pose"] in {r["name"] for r in rows}


def test_both_marches_render_the_same_images(gates):
    """The K6 production frame against the K2 one at each pose: ≥ 40 dB."""
    from fashion_nerf_torch.metrics import psnr
    out, _ = gates
    for a, b in zip(out["true"]["rows"], out["false"]["rows"]):
        assert float(psnr(b["image"], a["image"])) >= 40.0


@pytest.mark.parametrize("ok,code", [(True, 0), (False, 1)])
def test_main_exit_code(monkeypatch, ok, code):
    """The entry point exits 1 on FAIL, 0 on PASS, and passes its flags."""
    seen = {}

    def fake(extra, poses, device, H, W, log):
        seen.update(extra=extra, poses=poses, device=device.type, H=H)
        return {"ok": ok}

    monkeypatch.setattr(quality, "run_gate", fake)
    assert quality.main(["--gate", "--device", "cpu", "--size", "16",
                         "--extra", "a.b=1, c.d=2", "--poses", "0,5"]) == code
    assert seen == {"extra": ["a.b=1", "c.d=2"], "poses": [0, 5],
                    "device": "cpu", "H": 16}


def test_main_refuses_without_gate_or_cuda(monkeypatch):
    """Without --gate the entry point runs the spec sweep with its flags;
    without CUDA and without --device cpu either mode raises."""
    seen = {}

    def fake(only, pose, device, H, W, overrides, log):
        seen.update(only=only, pose=pose, device=device.type, H=H,
                    overrides=overrides)
        return {"rows": [], "pose": pose}

    monkeypatch.setattr(quality, "run_sweep", fake)
    assert quality.main(["--device", "cpu", "--size", "16", "--pose", "2",
                         "--only", "dense, w256d3", "--extra",
                         "a.b=1"]) == 0
    assert seen == {"only": ["dense", "w256d3"], "pose": 2, "device": "cpu",
                    "H": 16, "overrides": ["a.b=1"]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--gate"], []):
        with pytest.raises(RuntimeError, match="CUDA"):
            quality.main(argv)
