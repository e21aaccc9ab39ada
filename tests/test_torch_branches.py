"""The last blockwise branches against the JAX reference on the CPU:
occupancy-warped sampling with width caps (`occupancy.sample_warp`), the
union of the proposal and fine samples (`proposal.union`) and stratified
coverage samples (`proposal.cov_n`).

- `occupancy_bins`, `warp_stratified` and `delta_caps` of
  fashion_nerf_torch.core.sampling against the reference's on seeded random
  segments, a fragmented union (two occupied runs, 30% of the range) and a
  fully occupied one: occ and gap_idx exactly equal, t within 1e-6
  relative (about two f32 ulps at t ≈ 5: the reference's XLA cumsum of
  the bin masses sums in another order than torch.cumsum, 7.7e-7 apart on
  the cdf of one case);
- `render_rays_blockwise` of the trained flagship and the committed
  proposal on 128 rays under each branch, against the reference's (its
  Pallas marches in interpret mode) at the config of
  tests/kernels/test_blockwise.py:25-36 with the flagship's carry march
  (K1 + K2's plain versions), and the warp also through the two-stage
  march (`kernels.fused_carry=false`): fine rgb ≥ 40 dB, acc within 2e-2.
  Both sides take the same occupancy state (32³ through the port's plain
  field), so they cull alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.core import sampling as js
from fashion_nerf.core.occupancy import OccupancyState as JOcc
from fashion_nerf.models.proposal import attach_proposal as j_attach
from fashion_nerf.render import blockwise as jbw
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.core import sampling as ts
from fashion_nerf_torch.core.occupancy import build_from_config
from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# the sampling helpers
# --------------------------------------------------------------------------

def _rand_segs(rng, R=6, K=5, t_lo=2.0, t_hi=6.0):
    """tests/unit/test_sampling.py's random segments: every ray keeps one."""
    lo = rng.uniform(t_lo, t_hi, size=(R, K)).astype(np.float32)
    hi = np.minimum(lo + rng.uniform(0.05, 1.2, size=(R, K)), t_hi).astype(
        np.float32)
    hit = rng.uniform(size=(R, K)) > 0.3
    hit[:, 0] = True
    return lo, hi, hit


FRAGMENTED = (np.array([[2.4, 4.4]], np.float32),
              np.array([[3.0, 5.0]], np.float32), np.ones((1, 2), bool))
FULL = (np.array([[1.0]], np.float32), np.array([[7.0]], np.float32),
        np.ones((1, 1), bool))


@pytest.mark.parametrize("case,nbins,n", [
    ("random", 16, 20), ("random", 64, 48), ("fragmented", 40, 64),
    ("full", 16, 24)])
def test_sampling_helpers_match_reference(case, nbins, n):
    rng = np.random.default_rng(nbins + n)
    if case == "random":
        seg = _rand_segs(rng)
        R = seg[0].shape[0]
        t_lo = rng.uniform(1.5, 2.5, R).astype(np.float32)
        t_hi = rng.uniform(5.5, 6.5, R).astype(np.float32)
    else:
        seg = FRAGMENTED if case == "fragmented" else FULL
        t_lo, t_hi = np.array([2.0], np.float32), np.array([6.0], np.float32)
    occ_j, gap_j = js.occupancy_bins(tuple(map(jnp.asarray, seg)),
                                     jnp.asarray(t_lo), jnp.asarray(t_hi),
                                     nbins)
    seg_t = tuple(torch.from_numpy(x.copy()) for x in seg)
    occ_t, gap_t = ts.occupancy_bins(seg_t, torch.from_numpy(t_lo),
                                     torch.from_numpy(t_hi), nbins)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(gap_t.numpy(), np.asarray(gap_j))
    t_j = js.warp_stratified(occ_j, jnp.asarray(t_lo), jnp.asarray(t_hi), n)
    t_t = ts.warp_stratified(occ_t, torch.from_numpy(t_lo),
                             torch.from_numpy(t_hi), n)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-6,
                               atol=0)
    assert bool((t_t[:, 1:] >= t_t[:, :-1]).all())
    # caps at the reference's own samples and at samples between them
    t_mid = np.asarray(t_j)[:, :-1] + 0.37 * np.diff(np.asarray(t_j), axis=1)
    for t in (np.array(t_j), t_mid.astype(np.float32)):
        cap_j = js.delta_caps(gap_j, jnp.asarray(t_lo), jnp.asarray(t_hi),
                              jnp.asarray(t))
        cap_t = ts.delta_caps(gap_t, torch.from_numpy(t_lo),
                              torch.from_numpy(t_hi), torch.from_numpy(t))
        np.testing.assert_allclose(cap_t.numpy(), np.asarray(cap_j),
                                   rtol=1e-6, atol=0)
    if case == "fragmented":       # the whole budget lands in the runs
        lo, hi, _ = seg
        tt = t_t.numpy()
        in_run = ((tt >= lo[0, 0]) & (tt <= hi[0, 0])) | (
            (tt >= lo[0, 1]) & (tt <= hi[0, 1]))
        assert in_run.mean() > 0.95
    if case == "full":             # midpoint strata over [t_lo, t_hi]
        u = (np.arange(n) + 0.5) / n
        np.testing.assert_allclose(t_t.numpy()[0], 2.0 + 4.0 * u, atol=2e-3)


# --------------------------------------------------------------------------
# render_rays_blockwise under each branch
# --------------------------------------------------------------------------

# tests/kernels/test_blockwise.py:25-36 with the flagship's carry march, and
# the occupancy grid at 32³
BR = ["kernels.use_pallas=true", "kernels.interpret=true",
      "sampling.n_coarse=32", "sampling.n_fine=32",
      "render.eval_n_coarse=0", "render.eval_n_fine=0",
      "occupancy.resolution=32"]


def _fan(R=128, z=4.0, spread=0.3):
    ang = np.linspace(-spread, spread, R).astype(np.float32)
    ro = np.broadcast_to(np.array([0.0, 0.0, z], np.float32), (R, 3)).copy()
    rd = np.stack([np.sin(ang), 0.05 * np.cos(3 * ang), -np.cos(ang)],
                  -1).astype(np.float32)
    return ro, rd


@pytest.fixture(scope="module")
def scene():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    tree = loaded[0]
    cfg = load_config("blender_lego", BR)
    fine = load_flax_params(tree["fine"], compute_dtype="bfloat16")
    field = make_fused_field()
    with torch.no_grad():
        occ_t = build_from_config(cfg, lambda p, v: field(fine, p, v))
    occ_j = JOcc(*[jnp.asarray(x.numpy()) for x in occ_t])
    params_j = j_attach(j_load_config("blender_lego", BR),
                        {"fine": tree["fine"]}, allow_distill=False)
    params_t = attach_proposal(cfg, {"fine": fine}, allow_distill=False)
    assert "proposal" in params_j and "proposal" in params_t
    return params_j, occ_j, params_t, occ_t


@pytest.mark.parametrize("ovr", [
    ["proposal.cov_n=16"], ["proposal.union=true"],
    ["occupancy.sample_warp=true"],
    ["occupancy.sample_warp=true", "kernels.fused_carry=false"]],
    ids=["cov_n", "union", "sample_warp", "sample_warp_twostage"])
def test_render_rays_branch_matches_reference(scene, ovr):
    params_j, occ_j, params_t, occ_t = scene
    cfg_j = j_load_config("blender_lego", BR + ovr)
    cfg_t = load_config("blender_lego", BR + ovr)
    ro, rd = _fan()
    out_j = jbw.render_rays_blockwise(params_j, cfg_j, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(rd),
                                      occ=occ_j)
    with torch.no_grad():
        out_t = tbw.render_rays_blockwise(
            params_t, cfg_t, torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(rd), occ=occ_t)
    rgb_j = torch.from_numpy(np.array(out_j["fine"]["rgb"]))
    assert float(psnr(out_t["fine"]["rgb"], rgb_j)) >= 40.0
    np.testing.assert_allclose(out_t["fine"]["acc"].numpy(),
                               np.asarray(out_j["fine"]["acc"]), atol=2e-2)
    acc = out_t["fine"]["acc"].numpy()
    assert acc.max() > 0.9 and acc.min() < 0.1     # surface and misses
    # the fine march takes the branch's sample count
    n = tbw.fine_march_samples(cfg_t, occ_t)
    assert out_t["fine"]["weights"].shape == (128, n)
    assert n == {"proposal.cov_n=16": 48, "proposal.union=true": 96}.get(
        ovr[0], 32)
