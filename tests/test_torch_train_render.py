"""The dense render and the training-time culling of the port against the
reference on the CPU (the reference's Pallas kernels in interpret mode,
the port's plain versions):

- K5's plain version against `fused_render_rays` at S=64 and S=192 with
  pad rays (rgb, depth, acc, weights, disp at 1e-5);
- `evaluate` of the held-out view against the reference's (≥ 40 dB between
  the images, val PSNRs within 0.05 dB);
- the occupancy-culled step against the reference's, each side refreshing
  its grid from its own nets: the same grid and box, the same loss.

Small nets (3×32, L=4, a skip after layer 1) and a 16×16 two-view scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.data.pipeline import RayDataset as JRayDataset
from fashion_nerf.data.synthetic import make_synthetic_scene
from fashion_nerf.kernels.render_pallas import fused_render_rays as j_frr
from fashion_nerf.train import loop as jloop
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch.core.volrend import volume_render
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.kernels import render
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import TrainState, make_optimizer

torch.set_num_threads(2)

SMALL = ["kernels.interpret=true", "model.net_depth=3", "model.net_width=32",
         "model.posenc_xyz=4", "model.skips=1", "train.batch_rays=64",
         "sampling.n_coarse=16", "sampling.n_fine=16",
         "sampling.perturb=false", "train.sparsity_weight=1e-4",
         "train.sparsity_points=64", "train.precrop_iters=0",
         "occupancy.resolution=16", "occupancy.macro=4", "render.chunk=192",
         "train.occ_coarse=8", "train.occ_fine=8"]


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=2, H=16, W=16, n_samples=32)


def _port_state(cfg, params):
    nets = {k: load_flax_params(jax.device_get(params[k]),
                                compute_dtype=cfg.model.compute_dtype)
            for k in ("coarse", "fine")}
    ps = [p for n in nets.values() for p in n.parameters()]
    return TrainState(step=0, coarse=nets["coarse"], fine=nets["fine"],
                      optimizer=make_optimizer(cfg, ps),
                      generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("white", [False, True])
def test_k5_plain_matches_reference(S, white):
    """300 rays: the reference pads them to two 256-ray tiles, and S=192
    to 256 lanes."""
    rng = np.random.default_rng(S)
    R = 300
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    sigma = rng.normal(0, 8, (R, S)).astype(np.float32)
    sigma[:30] = -1.0                                      # empty rays
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    oj = j_frr(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(t),
               jnp.asarray(rd), white_bkgd=white, interpret=True)
    ot = render.fused_render_rays(*(torch.from_numpy(x) for x in
                                    (rgb, sigma, t, rd)), white_bkgd=white)
    for k in ("rgb", "depth", "acc", "weights", "disp"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_k5_backward_is_volume_render_autograd():
    rng = np.random.default_rng(0)
    R, S = 8, 16
    args = [torch.tensor(x, requires_grad=True) for x in (
        rng.uniform(0, 1, (R, S, 3)).astype(np.float32),
        rng.normal(0, 3, (R, S)).astype(np.float32),
        np.sort(rng.uniform(2, 6, (R, S)), 1).astype(np.float32),
        rng.normal(size=(R, 3)).astype(np.float32))]
    w = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32)
    (render.fused_render_rays(*args, white_bkgd=True)["rgb"] * w).sum(
        ).backward()
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    (volume_render(*args, white_bkgd=True)["rgb"] * w).sum().backward()
    for a, g in zip(args, got):
        torch.testing.assert_close(g, a.grad)


def test_evaluate_matches_reference(scene):
    cfg = load_config("blender_lego", SMALL)
    jstate = j_create(cfg, jax.random.PRNGKey(0))
    jds = JRayDataset(scene["images"], scene["poses"], scene["focal"])
    jds.val_image, jds.val_pose = scene["val_image"], scene["val_pose"]
    out_j, psnr_j = jloop.evaluate(cfg, jstate, jds)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    ds.val_image, ds.val_pose = scene["val_image"], scene["val_pose"]
    out_t, psnr_t = loop.evaluate(cfg, _port_state(cfg, jstate.params), ds)
    rgb_j = torch.from_numpy(np.array(out_j["rgb"]))
    assert out_t["rgb"].shape == rgb_j.shape == (16, 16, 3)
    assert float(psnr(out_t["rgb"], rgb_j)) >= 40.0
    assert abs(psnr_t - psnr_j) <= 0.05


def test_occ_culled_step_matches_reference(scene):
    cfg = load_config("blender_lego", SMALL)
    jstate = j_create(cfg, jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    port = _port_state(cfg, params0)
    occ_j = jloop.refresh_occupancy(cfg, jstate.params)
    occ_t = loop.refresh_occupancy(cfg, port)
    np.testing.assert_array_equal(occ_t.grid.numpy(), np.asarray(occ_j.grid))
    np.testing.assert_allclose(occ_t.box_min.numpy(),
                               np.asarray(occ_j.box_min), atol=1e-6)
    np.testing.assert_allclose(occ_t.box_max.numpy(),
                               np.asarray(occ_j.box_max), atol=1e-6)
    jds = JRayDataset(scene["images"], scene["poses"], scene["focal"])
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    idx = np.random.default_rng(0).choice(jds.n_rays, 64, replace=False)
    jb = {k: v[idx] for k, v in jds.batch_arrays().items()}
    tb = {k: v[torch.from_numpy(idx)] for k, v in ds.batch_arrays().items()}
    _, _, k_render = jax.random.split(jstate.key, 3)
    pts = jax.random.uniform(jax.random.fold_in(k_render, 17), (64, 1, 3),
                             minval=cfg.occupancy.world_min,
                             maxval=cfg.occupancy.world_max)
    jstep = jloop.make_train_step(cfg, jds, streamed=True, occ_culled=True)
    _, m = jstep(jstate, jb, occ_j)
    step = loop.TrainStep(cfg, ds, streamed=True, occ_culled=True)
    assert (step.cfg.sampling.n_coarse, step.cfg.sampling.n_fine) == (8, 8)
    _, mt = step(port, tb, occ_t, sparsity_pts=torch.from_numpy(
        np.array(pts)))
    for k in ("loss", "mse_coarse", "mse_fine", "sparsity"):
        assert abs(float(mt[k]) - float(m[k])) <= 1e-4 * abs(float(m[k])), k
