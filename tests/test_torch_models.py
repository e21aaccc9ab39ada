"""The port's fields (fashion_nerf_torch.models) against the JAX reference:
weights carried across from the reference's parameter trees, the proposal
asset's sha256 teacher match and the distillation on a mismatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship, load_params
from fashion_nerf.config import load_config
from fashion_nerf.models.nerf_mlp import init_field, make_field
from fashion_nerf.models.proposal import proposal_model_config as j_pmc
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import (PROPOSAL_ASSET,
                                                _teacher_signature,
                                                attach_proposal,
                                                proposal_model_config)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flagship():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    return loaded


def _inputs(R=8, S=16, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    return pts, dirs


def _both(mcfg, tree, pts, dirs):
    _, field = make_field(mcfg)
    rgb_j, sig_j = field(tree, jnp.asarray(pts), jnp.asarray(dirs), None)
    model = load_flax_params(jax.device_get(tree),
                             compute_dtype=mcfg.compute_dtype)
    with torch.no_grad():
        rgb_t, sig_t = model.field(torch.from_numpy(pts),
                                   torch.from_numpy(dirs))
    return (np.asarray(rgb_j), np.asarray(sig_j), rgb_t.numpy(),
            sig_t.numpy())


@pytest.mark.parametrize("which", ["fine", "proposal"])
def test_load_flax_params_init_f32(which):
    """f32 trees from init_field: same layer mapping ⇒ f32 agreement
    (atol 1e-4 on rgb, 1e-4·(1+|σ|) on σ: summation order only)."""
    cfg = load_config("blender_lego")
    mcfg = cfg.model if which == "fine" else j_pmc(cfg)
    mcfg = dataclasses.replace(mcfg, compute_dtype="float32")
    tree = init_field(jax.random.PRNGKey(1), mcfg)
    pts, dirs = _inputs()
    rgb_j, sig_j, rgb_t, sig_t = _both(mcfg, tree, pts, dirs)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=1e-4)
    assert np.all(np.abs(sig_t - sig_j) <= 1e-4 * (1 + np.abs(sig_j)))


def test_load_flax_params_flagship_bf16(flagship):
    """The trained flagship under the preset's bf16 compute dtype. Each
    Dense rounds its output to bf16 on both sides; f32 summation order can
    flip a bf16 rounding, so rgb atol 1e-2 and σ 2e-2·(1+|σ|)."""
    params, _ = flagship
    mcfg = load_config("blender_lego").model
    assert mcfg.compute_dtype == "bfloat16"
    pts, dirs = _inputs(R=16, S=32, seed=1)
    rgb_j, sig_j, rgb_t, sig_t = _both(mcfg, params["fine"], pts, dirs)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=1e-2)
    assert np.all(np.abs(sig_t - sig_j) <= 2e-2 * (1 + np.abs(sig_j)))


def test_flax_tree_round_trip(flagship):
    params, _ = flagship
    model = load_flax_params(params["fine"])
    back = model.to_flax_params()["params"]
    for name, leaf in params["fine"]["params"].items():
        np.testing.assert_array_equal(back[name]["kernel"], leaf["kernel"])
        np.testing.assert_array_equal(back[name]["bias"], leaf["bias"])


def test_teacher_signature_matches_asset(flagship):
    """The port's sha256 equals the asset's teacher_sig exactly, from the
    parameter tree and from the loaded module."""
    params, _ = flagship
    _, meta = load_params(PROPOSAL_ASSET)
    sig = str(meta["teacher_sig"])
    assert _teacher_signature(params["fine"]) == sig
    assert _teacher_signature(load_flax_params(params["fine"])) == sig


def test_attach_proposal_finds_asset(flagship):
    params, _ = flagship
    cfg = load_config("blender_lego")
    fine = load_flax_params(params["fine"], compute_dtype="bfloat16")
    out = attach_proposal(cfg, {"fine": fine})
    prop = out["proposal"]
    pm = proposal_model_config(cfg)
    assert (prop.depth, prop.width, prop.posenc_xyz, prop.use_viewdirs) == (
        pm.net_depth, pm.net_width, pm.posenc_xyz, False)
    asset, _ = load_params(PROPOSAL_ASSET)
    np.testing.assert_array_equal(
        prop.trunk[0].weight.detach().numpy().T,
        asset["params"]["trunk_0"]["kernel"])


def test_attach_proposal_raises_on_other_weights(flagship, capsys):
    """A fine net the asset was not distilled for never reuses the asset:
    with allow_distill=False the params come back without a proposal (the
    renderer then takes the full coarse march), and with it a proposal is
    distilled for these weights."""
    params, _ = flagship
    cfg = load_config("blender_lego", ["proposal.distill_steps=2",
                                       "proposal.distill_batch=64"])
    fine = load_flax_params(params["fine"], compute_dtype="bfloat16")
    with torch.no_grad():
        fine.trunk[3].bias[0] += 1e-3
    nets = {"fine": fine}
    assert attach_proposal(cfg, nets, allow_distill=False) is nets
    out = attach_proposal(cfg, nets)
    assert "proposal distilled in 2 steps" in capsys.readouterr().err
    prop = out["proposal"]
    assert (prop.depth, prop.width, prop.use_viewdirs) == (2, 128, False)
    asset, _ = load_params(PROPOSAL_ASSET)
    assert not np.array_equal(prop.trunk[0].weight.detach().numpy().T,
                              asset["params"]["trunk_0"]["kernel"])
