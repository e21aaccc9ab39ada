"""The port's occupancy culling (fashion_nerf_torch.core.occupancy) against
the JAX reference: slab tests, the lattice sweep and its macro boxes."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config
from fashion_nerf.core import occupancy as jocc
from fashion_nerf.models.nerf_mlp import make_field
from fashion_nerf_torch.core import occupancy as tocc
from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

torch.set_num_threads(2)


def _rays(R=64, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2.5, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd[:4, 0] = 0.0                     # axis-parallel: the 1e-10 guard
    rd[4:6, :2] = 0.0
    return ro, rd


def test_ray_aabb_intersect():
    """Same slab arithmetic: equal hits, t exact up to f32 rounding."""
    ro, rd = _rays()
    bmin = np.array([-0.8, -0.6, -0.9], np.float32)
    bmax = np.array([0.7, 0.9, 0.5], np.float32)
    lo_j, hi_j, hit_j = jocc.ray_aabb_intersect(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bmin),
        jnp.asarray(bmax), 2.0, 6.0)
    lo_t, hi_t, hit_t = tocc.ray_aabb_intersect(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(bmin),
        torch.from_numpy(bmax), 2.0, 6.0)
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    assert 0 < int(hit_t.sum()) < len(ro)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), rtol=1e-6)
    np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), rtol=1e-6)


def _analytic_state(g=16, macro=4, margin=1):
    """A two-blob σ field on a g³ lattice through both builds."""
    def sigma(p, xp):
        a = xp.sqrt(((p - xp.asarray([0.5, 0.2, -0.3])) ** 2).sum(-1)) < 0.45
        b = xp.sqrt(((p - xp.asarray([-0.9, -0.6, 0.8])) ** 2).sum(-1)) < 0.3
        return xp.where(a | b, 5.0, -1.0)

    def jfield(pts, dirs, cond):
        return None, sigma(pts, jnp)

    def tfield(pts, dirs):
        return None, sigma(pts, torch)

    kw = dict(resolution=g, sigma_threshold=0.1, margin_cells=margin,
              macro=macro, chunk=1024)
    return (jocc.build_occupancy(jfield, -2.0, 2.0, **kw),
            tocc.build_occupancy(tfield, -2.0, 2.0, **kw))


@pytest.mark.parametrize("margin", [0, 1, 2])
def test_build_occupancy_analytic(margin):
    """An analytic σ field: equal grids, global box and macro boxes."""
    js, ts = _analytic_state(margin=margin)
    np.testing.assert_array_equal(ts.grid.numpy(), np.asarray(js.grid))
    np.testing.assert_array_equal(ts.boxes_occ.numpy(),
                                  np.asarray(js.boxes_occ))
    occ = np.asarray(js.boxes_occ)
    assert 0 < occ.sum() < occ.size
    for name in ("box_min", "box_max"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-6)
    for name in ("boxes_min", "boxes_max"):
        np.testing.assert_allclose(getattr(ts, name).numpy()[occ],
                                   np.asarray(getattr(js, name))[occ],
                                   atol=1e-6)


def test_build_occupancy_empty_grid():
    """An empty grid degrades to one full-extent box, as in the reference."""
    def tfield(pts, dirs):
        return None, torch.full(pts.shape[:2], -1.0)
    ts = tocc.build_occupancy(tfield, -2.0, 2.0, resolution=8, macro=2,
                              chunk=512)
    assert not bool(ts.grid.any())
    assert ts.boxes_occ.tolist() == [True] + [False] * 7
    np.testing.assert_array_equal(ts.box_min.numpy(), -2.0)
    np.testing.assert_array_equal(ts.boxes_max.numpy()[0], 2.0)


def test_ray_multi_aabb():
    """Per-box slab tests against the analytic macro boxes: equal hits,
    union intervals and segments exact up to f32 rounding."""
    js, _ = _analytic_state()
    ts = tocc.OccupancyState(*[torch.from_numpy(np.array(x)) for x in js])
    ro, rd = _rays(R=128, seed=1)
    rd = -ro + np.random.default_rng(2).normal(0, 0.3, ro.shape).astype(
        np.float32)                     # aim roughly at the origin
    outs_j = jocc.ray_multi_aabb(jnp.asarray(ro), jnp.asarray(rd), js, 0.1,
                                 6.0)
    outs_t = tocc.ray_multi_aabb(torch.from_numpy(ro), torch.from_numpy(rd),
                                 ts, 0.1, 6.0)
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=str(i))
    assert 0 < int(outs_t[2].sum()) < len(ro)


def test_flagship_grid_res32():
    """The trained fine field at resolution 32: the port sweeps the packed
    field (kernel K3's plain version), the reference its bf16 flax field.
    bf16 rounding flips cells whose σ sits at the 0.1 threshold, so ≥ 99.9%
    of cells must agree, and the macro-box set nearly so."""
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    params, _ = loaded
    cfg = load_config("blender_lego", ["occupancy.resolution=32"])
    _, jfield = make_field(cfg.model)
    js = jocc.build_from_config(cfg, functools.partial(jfield,
                                                       params["fine"]))
    fine = load_flax_params(params["fine"], compute_dtype="bfloat16")
    field = make_fused_field()
    with torch.no_grad():
        ts = tocc.build_from_config(cfg, lambda p, v: field(fine, p, v))
    agree = float((ts.grid.numpy() == np.asarray(js.grid)).mean())
    assert agree >= 0.999, agree
    assert int(ts.grid.sum()) > 0
    box_agree = float((ts.boxes_occ.numpy()
                       == np.asarray(js.boxes_occ)).mean())
    assert box_agree >= 0.99, box_agree
