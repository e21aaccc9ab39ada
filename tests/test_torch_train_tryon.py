"""A conditioned training step of the port against the reference's, on the
CPU, for both try-on presets (`viton_tryon`: a garment code into trunk_0
and the skip layer; `dynamic_tryon`: that code and each ray's frame latent).
The reference's fused field runs its Pallas kernels in interpret mode (its
backward through `_pallas_backward` with the cond), the port's fused field
its plain versions (K3 forward, K4 backward with d_condpart).

The streamed step takes a pre-gathered batch with `frame_ids`, no jitter,
the sparsity prior on (the reference's prior points fed to the port) and
one garment stack; the cond is built inside the step on both sides
(`_make_cond`, `make_cond`), so the encoder and the latent table are part
of the graph. Held: the loss (1e-4 relative); every gradient of coarse,
fine, encoder and latents inside the reference's envelope around f32 truth
(tests/kernels/test_posenc_mlp.py:229-234) and within 1e-3 relative RMS of
the reference's Pallas gradient; the parameters after two Adam steps
(tests/test_torch_train_step.py's rule), the second also with the port's
own Adam moments from its first step, and the rule's breaking under
ulp-sized noise pinned (why no fully chained run is held to it); and the
plain conditioned field
(`kernels.use_pallas=false`) against the reference's XLA field with a
cond: loss 1e-4 relative, gradients inside the envelope.

Small nets (3×32, L = 4, a skip after layer 1, a 16-wide code, 8-wide
latents of 4 frames), 64-ray batches, 16 + 16 samples, a 16×16 two-view
scene, a random 16×16 garment stack. Reference results are module-scoped:
each reference jit compiles once."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.data.pipeline import RayDataset as JRayDataset
from fashion_nerf.data.synthetic import make_synthetic_scene
from fashion_nerf.render.renderer import render_rays as j_render_rays
from fashion_nerf.train import loop as jloop
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.models.nerf_mlp import module_field
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import learning_rate, state_from_params

torch.set_num_threads(2)

PRESETS = ("viton_tryon", "dynamic_tryon")
SMALL = ["kernels.interpret=true", "model.net_depth=3", "model.net_width=32",
         "model.posenc_xyz=4", "model.skips=1", "model.condition_dim=16",
         "model.compute_dtype=bfloat16", "train.batch_rays=64",
         "sampling.n_coarse=16", "sampling.n_fine=16",
         "sampling.perturb=false", "sampling.raw_noise_std=0.0",
         "train.sparsity_points=64", "train.precrop_iters=0"]
LATENTS = ["model.n_latents=4", "model.latent_dim=8"]


def _cfg(preset, *ovr):
    extra = LATENTS if preset == "dynamic_tryon" else []
    return load_config(preset, SMALL + extra + list(ovr))


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _ref_loss_grad(cfg, params, batch, k_render, garment):
    """The reference step's loss_fn (train/loop.py:83-104) with its cond,
    and its gradients over every params tree."""
    field_c, field_f = jloop.make_fields(cfg, training=True)

    def loss_fn(p):
        cond = jloop._make_cond(cfg, p, batch, garment)
        fc = functools.partial(jloop._with_viewdirs(field_c), p["coarse"],
                               batch["viewdirs"])
        ff = functools.partial(jloop._with_viewdirs(field_f), p["fine"],
                               batch["viewdirs"])
        out = j_render_rays(fc, ff, batch["rays_o"], batch["rays_d"],
                            k_render, cfg, train=True, cond=cond)
        loss = (jnp.mean((out["coarse"]["rgb"] - batch["rgb"]) ** 2)
                + jnp.mean((out["fine"]["rgb"] - batch["rgb"]) ** 2))
        return loss + cfg.train.sparsity_weight * jloop._sparsity_loss(
            cfg, p, field_c, field_f, jax.random.fold_in(k_render, 17), cond)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax.device_get(g)


def _prior_pts(cfg, key):
    """The points the reference's step draws from its state key."""
    _, _, k_render = jax.random.split(key, 3)
    pts = jax.random.uniform(jax.random.fold_in(k_render, 17),
                             (cfg.train.sparsity_points, 1, 3),
                             minval=cfg.occupancy.world_min,
                             maxval=cfg.occupancy.world_max)
    return k_render, torch.from_numpy(np.array(pts))


def flax_grads(state) -> dict:
    """The port's gradients in the reference's layout, by (tree, layer,
    leaf)."""
    out = {}
    for k in ("coarse", "fine"):
        for name, layer in getattr(state, k).named_dense():
            out[k, name, "kernel"] = layer.weight.grad.numpy().T
            out[k, name, "bias"] = layer.bias.grad.numpy()
    if state.encoder is not None:
        for i, conv in enumerate(state.encoder.convs):
            out["encoder", f"conv_{i}", "kernel"] = \
                conv.weight.grad.permute(2, 3, 1, 0).numpy()
            out["encoder", f"conv_{i}", "bias"] = conv.bias.grad.numpy()
        out["encoder", "proj", "kernel"] = \
            state.encoder.proj.weight.grad.numpy().T
        out["encoder", "proj", "bias"] = state.encoder.proj.bias.grad.numpy()
    if state.latents is not None:
        out["latents", "codes", "embedding"] = \
            state.latents.codes.weight.grad.numpy()
    return out


def flax_values(state) -> dict:
    """The port's parameters in the reference's layout (copies)."""
    out = {}
    for k in ("coarse", "fine"):
        for name, leaf in getattr(state, k).to_flax_params()[
                "params"].items():
            for kind, v in leaf.items():
                out[k, name, kind] = v
    if state.encoder is not None:
        for i, conv in enumerate(state.encoder.convs):
            out["encoder", f"conv_{i}", "kernel"] = \
                conv.weight.detach().permute(2, 3, 1, 0).numpy().copy()
            out["encoder", f"conv_{i}", "bias"] = \
                conv.bias.detach().numpy().copy()
        out["encoder", "proj", "kernel"] = \
            state.encoder.proj.weight.detach().numpy().T.copy()
        out["encoder", "proj", "bias"] = \
            state.encoder.proj.bias.detach().numpy().copy()
    if state.latents is not None:
        out["latents", "codes", "embedding"] = \
            state.latents.codes.weight.detach().numpy().copy()
    return out


def _leaf(tree, key):
    net, name, kind = key
    if net == "latents":
        return np.asarray(tree["latents"]["params"]["codes"]["embedding"])
    return np.asarray(tree[net]["params"][name][kind])


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=2, H=16, W=16, n_samples=32)


@pytest.fixture(scope="module")
def ref(scene):
    """Per preset: the reference's initial params, batch, garment, prior
    points, and its loss and gradients through the Pallas field, the bf16
    XLA field and the f32 XLA field, and its params after two jitted
    steps."""
    out = {}
    garment = np.random.default_rng(4).uniform(
        0, 1, (16, 16, 7)).astype(np.float32)
    for preset in PRESETS:
        cfg = _cfg(preset, "train.sparsity_weight=1e-4")
        jstate = j_create(cfg, jax.random.PRNGKey(0))
        params0 = jax.device_get(jstate.params)
        jds = JRayDataset(scene["images"], scene["poses"], scene["focal"])
        idx = np.random.default_rng(0).choice(jds.n_rays,
                                              cfg.train.batch_rays,
                                              replace=False)
        jb = {k: v[idx] for k, v in jds.batch_arrays().items()}
        k_render, pts = _prior_pts(cfg, jstate.key)
        g = jnp.asarray(garment)
        res = {"cfg": cfg, "params0": params0, "idx": idx, "pts": pts,
               "pal": _ref_loss_grad(cfg, params0, jb, k_render, g),
               "bf": _ref_loss_grad(_cfg(preset, "train.sparsity_weight=1e-4",
                                         "kernels.use_pallas=false"),
                                    params0, jb, k_render, g)}
        f32 = _cfg(preset, "train.sparsity_weight=1e-4",
                   "kernels.use_pallas=false", "model.compute_dtype=float32")
        with jax.default_matmul_precision("highest"):
            res["f32"] = _ref_loss_grad(f32, params0, jb, k_render, g)
        jstep = jloop.make_train_step(cfg, jds, garment=g, streamed=True)
        res["steps"] = []        # (prior points, loss, params, Adam state)
        for _ in range(2):
            pts_i = _prior_pts(cfg, jstate.key)[1]
            jstate, m = jstep(jstate, jb)
            res["steps"].append((pts_i, float(m["loss"]),
                                 jax.device_get(jstate.params),
                                 jax.device_get(jstate.opt_state[0])))
        out[preset] = res
    return out, garment


def _port(cfg, scene, r, garment):
    """The port's state carried from the reference's params, its batch and
    its step (the fused field's plain versions unless cfg says otherwise)."""
    state = state_from_params(cfg, r["params0"], torch.Generator())
    tds = RayDataset(scene["images"], scene["poses"], scene["focal"])
    tb = {k: v[torch.from_numpy(r["idx"])]
          for k, v in tds.batch_arrays().items()}
    step = loop.TrainStep(cfg, tds, streamed=True,
                          garment=torch.from_numpy(garment))
    return state, tb, step


@pytest.mark.parametrize("preset", PRESETS)
def test_conditioned_step_loss_and_gradients(ref, scene, preset):
    """The fused conditioned step: loss 1e-4 relative; every gradient of
    coarse, fine, encoder (and latents) inside the envelope and within
    1e-3 relative RMS of the reference's Pallas gradient."""
    refs, garment = ref
    r = refs[preset]
    state, tb, step = _port(r["cfg"], scene, r, garment)
    loss, aux = step.loss(state, tb, sparsity_pts=r["pts"])
    loss.backward()
    (l_pal, g_pal), (_, g_bf), (_, g_f32) = r["pal"], r["bf"], r["f32"]
    loss = float(loss.detach())
    assert abs(loss - l_pal) <= 1e-4 * abs(l_pal), (loss, l_pal)
    got = flax_grads(state)
    want = {"coarse", "fine", "encoder"} | (
        {"latents"} if preset == "dynamic_tryon" else set())
    assert {k[0] for k in got} == want
    for key, g in got.items():
        p, b, c = (_leaf(t, key) for t in (g_pal, g_bf, g_f32))
        scale = _rms(c) + 1e-12
        assert _rms(g - c) <= 2.5 * _rms(b - c) + 1e-6 + 1e-4 * scale, key
        assert _rms(g - p) <= 1e-3 * (_rms(p) + 1e-12), (key, _rms(g - p)
                                                         / _rms(p))
    # the code and the latents move the loss: their gradients are not zero
    assert _rms(got["encoder", "proj", "kernel"]) > 0.0
    assert float(aux["sparsity"]) > 0.0


def port_params(state):
    """(parameter, reference key, reference leaf → the parameter's layout)
    for every parameter of the state."""
    def t(a):
        return torch.from_numpy(np.array(a.T))

    def same(a):
        return torch.from_numpy(np.array(a))

    out = []
    for k in ("coarse", "fine"):
        for name, layer in getattr(state, k).named_dense():
            out += [(layer.weight, (k, name, "kernel"), t),
                    (layer.bias, (k, name, "bias"), same)]
    if state.encoder is not None:
        for i, conv in enumerate(state.encoder.convs):
            out += [(conv.weight, ("encoder", f"conv_{i}", "kernel"),
                     lambda a: same(np.transpose(a, (3, 2, 0, 1)))),
                    (conv.bias, ("encoder", f"conv_{i}", "bias"), same)]
        out += [(state.encoder.proj.weight, ("encoder", "proj", "kernel"), t),
                (state.encoder.proj.bias, ("encoder", "proj", "bias"), same)]
    if state.latents is not None:
        out.append((state.latents.codes.weight,
                    ("latents", "codes", "embedding"), same))
    return out


def load_adam(state, adam, step: int) -> None:
    """Put the reference's Adam state (optax ScaleByAdamState) into the
    port's optimizer, for the parameters of `state`, at `step`."""
    assert int(adam.count) == step
    for p, key, conv in port_params(state):
        state.optimizer.state[p] = {
            "step": torch.tensor(float(step)),
            "exp_avg": conv(_leaf(adam.mu, key)),
            "exp_avg_sq": conv(_leaf(adam.nu, key))}
    state.step = step


@pytest.mark.parametrize("preset", PRESETS)
def test_conditioned_step_adam_matches_reference(ref, scene, preset):
    """Two full steps (Adam included), each taken from the reference's
    state before it (its parameters and Adam moments): the losses 1e-4
    relative; at most 1% of each tensor's elements, encoder and latents
    included, move by more than 1e-2·lr away from the reference's move, and
    a tensor of fewer than 100 elements may hold one such element: where
    the two steps' gradients partly cancel, the second move amplifies their
    last-bit differences (measured: one of the fine trunk_1's 32 biases,
    |m|/√v = 0.55, off by 0.048·lr; the largest share elsewhere 0.65%).
    The chained steps are held by the two tests below."""
    refs, garment = ref
    r = refs[preset]
    cfg = r["cfg"]
    before = r["params0"]
    for i, (pts, lj, after, adam) in enumerate(r["steps"]):
        state, tb, step = _port(cfg, scene, dict(r, params0=before), garment)
        if i:
            load_adam(state, r["steps"][i - 1][3], i)
        p0 = flax_values(state)
        state, m = step(state, tb, sparsity_pts=pts)
        assert abs(float(m["loss"]) - lj) <= 1e-4 * abs(lj), (i, lj)
        assert state.step == i + 1
        for key, val in flax_values(state).items():
            upd_t = val - p0[key]
            upd_j = _leaf(after, key) - _leaf(before, key)
            off = np.abs(upd_t - upd_j) > 1e-2 * learning_rate(cfg, i)
            assert off.sum() <= max(1, 1e-2 * off.size), (i, key, off.sum())
            assert np.abs(upd_t).max() > 0.0, (i, key)
        before = after


def _second_step_off(cfg, scene, r, garment, noise=0.0):
    """The port's own first step, then its parameters set to the
    reference's after that step (plus `noise`·lr of seeded N(0, 1)) while
    its Adam moments stay its own, then the second step → {reference key:
    (elements whose move is more than 1e-2·lr off the reference's second
    move, elements)}."""
    state, tb, step = _port(cfg, scene, r, garment)
    (pts, _, after, _), (pts2, lj2, after2, _) = r["steps"]
    state, _ = step(state, tb, sparsity_pts=pts)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p, key, conv in port_params(state):
            p.copy_(conv(_leaf(after, key)))
            p.add_(noise * learning_rate(cfg, 0)
                   * torch.randn(p.shape, generator=gen))
    p1 = flax_values(state)
    state, m = step(state, tb, sparsity_pts=pts2)
    assert state.step == 2
    assert abs(float(m["loss"]) - lj2) <= 1e-4 * abs(lj2), (m["loss"], lj2)
    out = {}
    for key, val in flax_values(state).items():
        upd_j = _leaf(after2, key) - _leaf(after, key)
        off = np.abs(val - p1[key] - upd_j) > 1e-2 * learning_rate(cfg, 1)
        out[key] = (int(off.sum()), off.size)
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_chained_adam_step_carries_its_moments(ref, scene, preset):
    """The second step chained from the port's own first step, its Adam
    moments carried (its parameters are the reference's after that step):
    every tensor's move holds the two-step rule. So the optimizer state
    the port carries from step to step is the reference's."""
    refs, garment = ref
    r = refs[preset]
    for key, (n_off, size) in _second_step_off(r["cfg"], scene, r,
                                               garment).items():
        assert n_off <= max(1, 1e-2 * size), (key, n_off)


def test_two_step_rule_breaks_under_ulp_noise(ref, scene):
    """Reference caveat (pinned): the two-step rule does not survive
    noise of a few f32 ulps on the reference's own first-step parameters
    (1e-4·lr, ~5e-8), so no port step chained from its own first step can
    be held to it. With viton_tryon's garment code the second move of the
    fine trunk's kernels departs by more than 1e-2·lr on over 1% of their
    elements (measured: 31 of trunk_0's 1376, 23 of trunk_1's 1024; fully
    chained from the port's first step, 58 and 24)."""
    refs, garment = ref
    r = refs["viton_tryon"]
    off = _second_step_off(r["cfg"], scene, r, garment, noise=1e-4)
    broken = [k for k, (n, size) in off.items() if n > max(1, 1e-2 * size)]
    assert ("fine", "trunk_0", "kernel") in broken, off


@pytest.mark.parametrize("preset", PRESETS)
def test_plain_conditioned_field_step_matches_reference(ref, scene, preset):
    """kernels.use_pallas=false: the NeRFMLP's plain-torch field with its
    cond under autograd against the reference's XLA field with a cond (both
    bf16): loss 1e-4 relative; every gradient inside the reference's
    envelope around f32 truth. (Autograd rounds the bf16 cotangents at
    other points than XLA's transpose: the two bf16 fields' gradients
    differ by up to ~1% relative RMS on a bias, both as far from f32 truth.)
    """
    refs, garment = ref
    r = refs[preset]
    cfg = _cfg(preset, "train.sparsity_weight=1e-4",
               "kernels.use_pallas=false")
    state, tb, step = _port(cfg, scene, r, garment)
    assert step.field is module_field
    loss, _ = step.loss(state, tb, sparsity_pts=r["pts"])
    loss.backward()
    loss = float(loss.detach())
    (l_bf, g_bf), (_, g_f32) = r["bf"], r["f32"]
    assert abs(loss - l_bf) <= 1e-4 * abs(l_bf), (loss, l_bf)
    for key, g in flax_grads(state).items():
        b, c = _leaf(g_bf, key), _leaf(g_f32, key)
        scale = _rms(c) + 1e-12
        assert _rms(g - c) <= 2.5 * _rms(b - c) + 1e-6 + 1e-4 * scale, key
