"""The generic proposal march (`proposal.sigma_march=false`, or a
proposal budget over one block): the σ-only proposal net, which has no
view branch, through the multi-block march K2 (`slim_march_plain` on the
CPU) or K6, against the JAX reference on the CPU, its Pallas kernels in
interpret mode. The committed proposal asset and the trained flagship.

- the march alone: `marched_pass_slim` of the proposal net (2×128, L = 6,
  no skip layer: one hoisted x-layer, the 4-wide out head) against the
  reference's `_marched_pass_slim`, in one block of 64 and in two (a
  budget of 128), with a dead tile and a culled ray in a live tile:
  weights and acc atol 2e-3 (the reference's σ-march bound,
  tests/kernels/test_sigmamarch.py:86-88);
- the render: `render_rays_blockwise` with `proposal.sigma_march=false`
  through K2 and through K6 (`kernels.carry_hoist=false`) against the
  reference's on 128 rays: fine rgb ≥ 40 dB, proposal acc atol 5e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.kernels.posenc_mlp_pallas import make_block_evaluator
from fashion_nerf.models.proposal import attach_proposal as j_attach
from fashion_nerf.models.proposal import proposal_model_config
from fashion_nerf.render import blockwise as jbw
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.kernels import slimmarch
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)

OVR = ["kernels.interpret=true", "sampling.n_coarse=32",
       "sampling.n_fine=32", "proposal.sigma_march=false"]


@pytest.fixture(scope="module")
def nets():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    tree = loaded[0]
    cfg_j, cfg_t = j_load_config("blender_lego", OVR), load_config(
        "blender_lego", OVR)
    params_j = j_attach(cfg_j, {k: tree[k] for k in ("coarse", "fine")},
                        allow_distill=False)
    fine = load_flax_params(tree["fine"], compute_dtype="bfloat16")
    params_t = attach_proposal(cfg_t, {"fine": fine}, allow_distill=False)
    assert "proposal" in params_j and "proposal" in params_t
    return params_j, params_t


def _fan(R, z=4.0, spread=0.3):
    ang = np.linspace(-spread, spread, R).astype(np.float32)
    ro = np.broadcast_to(np.array([0.0, 0.0, z], np.float32), (R, 3)).copy()
    rd = np.stack([np.sin(ang), 0.05 * np.cos(3 * ang), -np.cos(ang)],
                  -1).astype(np.float32)
    return ro, rd


@pytest.mark.parametrize("n_prop", [64, 128])
def test_proposal_march_slim_matches_reference(nets, n_prop):
    params_j, params_t = nets
    ovr = OVR + [f"proposal.eval_n={n_prop}"]
    cfg_j, cfg_t = j_load_config("blender_lego", ovr), load_config(
        "blender_lego", ovr)
    R, SB = 6 * 32, 64
    ro, rd = _fan(R)
    t = np.broadcast_to(np.linspace(2.0, 6.0, n_prop, dtype=np.float32),
                        (R, n_prop)).copy()
    dn = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    alive0 = np.ones(R, bool)
    alive0[:32] = False                 # tile 0 dead
    alive0[100] = False                 # a culled ray in live tile 3
    prop_m = proposal_model_config(cfg_j)
    pack, hoist_dirs, _, _, _ = make_block_evaluator(cfg_j, mcfg=prop_m)
    packed = pack(params_j["proposal"])
    out_j = jbw._marched_pass_slim(
        packed, hoist_dirs(packed, jnp.asarray(rd)), None, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(t), jnp.asarray(dn),
        jnp.asarray(alive0), cfg_j, 6.0, L=prop_m.posenc_xyz, sb=SB)
    net = slimmarch.split_hoist(params_t["proposal"])
    assert not net.has_vd and not net.skips and len(net.x_kernels) == 1
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    with torch.no_grad():
        out_t = tbw.marched_pass_slim(
            net, None, slimmarch.hoist_rays(net, tro, trd),
            torch.from_numpy(t), torch.from_numpy(dn),
            torch.from_numpy(alive0), cfg_t, 6.0, sb=SB)
    for k in ("weights", "acc"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-3, err_msg=k)
    w = out_t["weights"].numpy()
    assert np.all(w[:32] == 0) and w[32:].sum(1).max() > 0.5
    assert w[100].sum() > 0.5       # marched with its live tile


@pytest.mark.parametrize("carry_hoist", [True, False])
def test_render_rays_generic_proposal_matches_reference(nets, carry_hoist):
    params_j, params_t = nets
    ovr = OVR + [f"kernels.carry_hoist={str(carry_hoist).lower()}"]
    cfg_j, cfg_t = j_load_config("blender_lego", ovr), load_config(
        "blender_lego", ovr)
    assert not tbw.use_sigma_march(cfg_t)
    ro, rd = _fan(128)
    out_j = jbw.render_rays_blockwise(params_j, cfg_j, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(rd))
    with torch.no_grad():
        out_t = tbw.render_rays_blockwise(
            params_t, cfg_t, torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(rd))
    rgb_j = torch.from_numpy(np.array(out_j["fine"]["rgb"]))
    assert float(psnr(out_t["fine"]["rgb"], rgb_j)) >= 40.0
    np.testing.assert_allclose(out_t["coarse"]["acc"].numpy(),
                               np.asarray(out_j["coarse"]["acc"]), atol=5e-3)
    assert out_t["fine"]["acc"].numpy().max() > 0.9
