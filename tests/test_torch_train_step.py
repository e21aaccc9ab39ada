"""One training step of the port against the reference's, on the CPU: the
reference's fused field runs its Pallas kernels in interpret mode, the
port's fused field its plain versions (K3 forward, K4 backward).

- the streamed step (a pre-gathered batch, no jitter) at sparsity weight 0
  and 1e-4, with the reference's sparsity points fed to the port: the loss,
  the gradients (each inside the reference's envelope around f32 truth,
  tests/kernels/test_posenc_mlp.py:283-288) and the parameters after two
  Adam steps;
- the occupancy-culled step, with the grid refreshed from the live nets on
  both sides;
- the learning-rate schedule at steps 0, 1 and lr_decay_steps.

Small nets (3×32, L=4, a skip after layer 1) and a 16×16 two-view scene."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.data.pipeline import RayDataset as JRayDataset
from fashion_nerf.data.synthetic import make_synthetic_scene
from fashion_nerf.render.renderer import render_rays as j_render_rays
from fashion_nerf.train import loop as jloop
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import (TrainState, learning_rate,
                                            make_optimizer)

torch.set_num_threads(2)

SMALL = ["kernels.interpret=true", "model.net_depth=3", "model.net_width=32",
         "model.posenc_xyz=4", "model.skips=1", "train.batch_rays=64",
         "sampling.n_coarse=16", "sampling.n_fine=16",
         "sampling.perturb=false", "train.sparsity_points=64",
         "train.precrop_iters=0"]


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=2, H=16, W=16, n_samples=32)


def _cfg(*ovr):
    return load_config("blender_lego", SMALL + list(ovr))


def _port_state(cfg, params):
    nets = {k: load_flax_params(jax.device_get(params[k]),
                                compute_dtype=cfg.model.compute_dtype)
            for k in ("coarse", "fine")}
    ps = [p for n in nets.values() for p in n.parameters()]
    return TrainState(step=0, coarse=nets["coarse"], fine=nets["fine"],
                      optimizer=make_optimizer(cfg, ps),
                      generator=torch.Generator().manual_seed(0))


def _batches(cfg, scene):
    jds = JRayDataset(scene["images"], scene["poses"], scene["focal"])
    tds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    idx = np.random.default_rng(0).choice(jds.n_rays, cfg.train.batch_rays,
                                          replace=False)
    jb = {k: v[idx] for k, v in jds.batch_arrays().items()}
    tb = {k: v[torch.from_numpy(idx)] for k, v in tds.batch_arrays().items()}
    return jds, tds, jb, tb


def _ref_sparsity_pts(cfg, key):
    """The points the reference's step draws from its state key."""
    _, _, k_render = jax.random.split(key, 3)
    pts = jax.random.uniform(jax.random.fold_in(k_render, 17),
                             (cfg.train.sparsity_points, 1, 3),
                             minval=cfg.occupancy.world_min,
                             maxval=cfg.occupancy.world_max)
    return k_render, torch.from_numpy(np.array(pts))


def _ref_loss_grad(cfg, params, batch, k_render):
    """The reference step's loss_fn (train/loop.py:83-104), with grads."""
    field_c, field_f = jloop.make_fields(cfg, training=True)

    def loss_fn(p):
        fc = functools.partial(jloop._with_viewdirs(field_c), p["coarse"],
                               batch["viewdirs"])
        ff = functools.partial(jloop._with_viewdirs(field_f), p["fine"],
                               batch["viewdirs"])
        out = j_render_rays(fc, ff, batch["rays_o"], batch["rays_d"],
                            k_render, cfg, train=True)
        loss = (jnp.mean((out["coarse"]["rgb"] - batch["rgb"]) ** 2)
                + jnp.mean((out["fine"]["rgb"] - batch["rgb"]) ** 2))
        if cfg.train.sparsity_weight > 0:
            loss = loss + cfg.train.sparsity_weight * jloop._sparsity_loss(
                cfg, p, field_c, field_f, jax.random.fold_in(k_render, 17),
                None)
        return loss

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _flat_grads(state):
    return {(k, name, kind): (layer.weight.grad.numpy().T if kind == "kernel"
                              else layer.bias.grad.numpy())
            for k, net in state.nets().items()
            for name, layer in net.named_dense()
            for kind in ("kernel", "bias")}


@pytest.mark.parametrize("sparsity", [0.0, 1e-4])
def test_streamed_step_matches_reference(scene, sparsity):
    """Loss rel 1e-4; over two Adam steps, at most 1% of each tensor's
    elements move by more than 1e-2·lr away from the reference's move (not
    every element: Adam normalises each gradient, so where a gradient is
    near zero or the two steps' gradients nearly cancel, last-bit
    differences move a parameter by up to ~2·lr; measured 0.23% of
    elements at worst); with
    prior on, every gradient inside the reference's envelope and within
    1e-3 relative RMS of the reference's Pallas gradient."""
    cfg = _cfg(f"train.sparsity_weight={sparsity}")
    jstate = j_create(cfg, jax.random.PRNGKey(0))
    jds, tds, jb, tb = _batches(cfg, scene)
    k_render, pts = _ref_sparsity_pts(cfg, jstate.key)
    params0 = jax.device_get(jstate.params)
    port = _port_state(cfg, params0)
    step = loop.TrainStep(cfg, tds, streamed=True)

    if sparsity > 0:
        loss_t, _ = step.loss(port, tb, sparsity_pts=pts)
        loss_t.backward()
        _, g_pal = _ref_loss_grad(cfg, params0, jb, k_render)
        _, g_bf = _ref_loss_grad(_cfg(f"train.sparsity_weight={sparsity}",
                                      "kernels.use_pallas=false"),
                                 params0, jb, k_render)
        f32 = _cfg(f"train.sparsity_weight={sparsity}",
                   "kernels.use_pallas=false", "model.compute_dtype=float32")
        with jax.default_matmul_precision("highest"):
            _, g_f32 = _ref_loss_grad(f32, params0, jb, k_render)
        for (k, name, kind), g in _flat_grads(port).items():
            c = np.asarray(g_f32[k]["params"][name][kind])
            b = np.asarray(g_bf[k]["params"][name][kind])
            p = np.asarray(g_pal[k]["params"][name][kind])
            scale = _rms(c) + 1e-12
            assert _rms(g - c) <= 2.5 * _rms(b - c) + 1e-6 + 1e-4 * scale, \
                (k, name, kind)
            assert _rms(g - p) <= 1e-3 * (_rms(p) + 1e-12), (k, name, kind)

    # the reference's jitted step (it donates its input state)
    jstep = jloop.make_train_step(cfg, jds, streamed=True)
    jstate = j_create(cfg, jax.random.PRNGKey(0))
    port = _port_state(cfg, params0)
    losses = []
    for _ in range(2):
        _, pts = _ref_sparsity_pts(cfg, jstate.key)
        jstate, m = jstep(jstate, jb)
        port, mt = step(port, tb, sparsity_pts=pts)
        losses.append((float(m["loss"]), float(mt["loss"])))
    for lj, lt in losses:
        assert abs(lt - lj) <= 1e-4 * abs(lj), losses
    jp = jax.device_get(jstate.params)
    for k, net in port.nets().items():
        for name, layer in net.named_dense():
            for kind, val in (("kernel", layer.weight.detach().numpy().T),
                              ("bias", layer.bias.detach().numpy())):
                p0 = params0[k]["params"][name][kind]
                upd_t = val - p0
                upd_j = np.asarray(jp[k]["params"][name][kind]) - p0
                off = np.abs(upd_t - upd_j) > 1e-2 * cfg.train.lr_init
                assert off.mean() <= 1e-2, (k, name, kind, off.mean())
    assert port.step == 2


def test_adam_matches_optax():
    """Fed the same gradients, the port's optimizer and learning-rate
    schedule give optax.adam(exponential_decay)'s parameters (rel 1e-6)."""
    cfg = load_config("blender_lego", ["train.lr_decay_steps=10"])
    t = cfg.train
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(scale=s, size=(64,)).astype(np.float32)
             for s in (1e-3, 1e-6)]
    tx = optax.adam(optax.exponential_decay(t.lr_init, t.lr_decay_steps,
                                            t.lr_final / t.lr_init))
    pj, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(cfg, [pt])
    for step, g in enumerate(grads):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, pj)
        pj = pj + upd
        pt.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = learning_rate(cfg, step)
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                               rtol=1e-6, atol=1e-9)


def test_learning_rate_schedule():
    cfg = load_config("blender_lego")
    t = cfg.train
    sched = optax.exponential_decay(t.lr_init, t.lr_decay_steps,
                                    t.lr_final / t.lr_init)
    for s in (0, 1, t.lr_decay_steps):
        assert learning_rate(cfg, s) == pytest.approx(float(sched(s)),
                                                      rel=1e-6)
    assert learning_rate(cfg, t.lr_decay_steps) == pytest.approx(t.lr_final)


def test_cli_train_on_cpu(tmp_path, capsys):
    """`python -m fashion_nerf_torch.cli train` trains, logs JSON lines,
    checkpoints under --out and ends with a JSON summary."""
    import json

    from fashion_nerf_torch import cli
    argv = ["train", "--config", "tiny_lego", "--device", "cpu", "--out",
            str(tmp_path)]
    for kv in ("model.net_depth=2", "model.net_width=32",
               "model.posenc_xyz=2", "sampling.n_coarse=8",
               "train.batch_rays=32", "train.iters=4", "train.log_every=2",
               "train.ckpt_every=4", "train.eval_every=100",
               "data.root="):
        argv += ["--set", kv]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["steps"] == 4
    assert sum(line.startswith("[fashion-nerf-torch] {\"loss\"")
               for line in out) == 2
    assert (tmp_path / "tiny_lego" / "ckpt" / "step_00000004.pt").exists()


@pytest.mark.parametrize("ovr", [["data.stream=true"],
                                 ["dist.multihost=true"]])
def test_train_runs_stream_and_multihost_in_one_process(ovr):
    """`data.stream` (host batches through the prefetch) and
    `dist.multihost` without a launcher (one process: the group is not
    joined) train; `dist.tp=2` under two ranks: tests/test_torch_dist.py."""
    cfg = load_config("tiny_lego", ovr + [
        "model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
        "sampling.n_coarse=8", "train.batch_rays=32", "train.iters=2",
        "train.log_every=1", "train.eval_every=100", "train.ckpt_every=100",
        "data.root="])
    with torch.enable_grad():
        state, hist = loop.train(cfg, log_fn=lambda e: None, device="cpu")
    assert state.step == 2
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_conditioned_field_on_cpu():
    """model.conditioned=true trains: a dataset without a garment takes
    the procedural pair's stack, the garment encoder joins the state and
    moves, and the loss stays finite."""
    cfg = load_config("tiny_lego", [
        "model.conditioned=true", "model.condition_dim=8",
        "model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
        "sampling.n_coarse=8", "train.batch_rays=32", "train.iters=3",
        "train.log_every=1", "train.eval_every=100", "train.ckpt_every=100",
        "data.root="])
    logs = []
    with torch.enable_grad():
        state, hist = loop.train(cfg, log_fn=logs.append, device="cpu")
    assert state.encoder is not None and state.step == 3
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(p.grad is not None for p in state.encoder.parameters())
