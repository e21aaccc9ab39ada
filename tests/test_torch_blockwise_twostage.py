"""The two-stage blockwise march (`kernels.fused_carry=false`: one field
launch a sample block with a per-tile skip flag, the compositing between
the launches) and NDC against the JAX reference on the CPU. The reference
runs its Pallas field kernel in interpret mode; the port runs K3's plain
version with the flag.

- K3 with the flag: `field_rows_plain(…, alive=…)` against the
  reference's block evaluator (`_fused_eval(…, alive=…, spr=SB)`) on a mix
  of live and dead tiles: dead rows exact sentinels (rgb 0, σ −1e10), live
  rows within K3's random-net bound (rgb 5e-3, σ 2e-2·(1+|σ|));
- `render_rays_blockwise` of the trained flagship at the config of
  tests/kernels/test_blockwise.py:25-36 on 128 rays, with and without
  termination (ε 1e-3 and 0; the trained nets made opaque and 64 coarse
  samples, so that rays do terminate) and with the committed proposal net through K3: rgb
  ≥ 40 dB, acc within 2e-2, alive_frac of every march equal;
- `render_image_blockwise` of a small `llff_fern` (NDC) on a 16×24 frame
  (scanline order) and a 16×16 frame (8×8 pixel blocks): ≥ 40 dB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.kernels.posenc_mlp_pallas import make_block_evaluator
from fashion_nerf.models.nerf_mlp import init_field
from fashion_nerf.models.proposal import attach_proposal as j_attach
from fashion_nerf.render import blockwise as jbw
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.kernels import posenc_mlp
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)

# tests/kernels/test_blockwise.py:25-36, two-stage
BW = ["kernels.use_pallas=true", "kernels.interpret=true",
      "sampling.n_coarse=32", "sampling.n_fine=32",
      "render.eval_n_coarse=0", "render.eval_n_fine=0",
      "kernels.fused_carry=false"]


def _fan(R=128, z=4.0, spread=0.3):
    ang = np.linspace(-spread, spread, R).astype(np.float32)
    ro = np.broadcast_to(np.array([0.0, 0.0, z], np.float32), (R, 3)).copy()
    rd = np.stack([np.sin(ang), 0.05 * np.cos(3 * ang), -np.cos(ang)],
                  -1).astype(np.float32)
    return ro, rd


def test_k3_plain_alive_matches_reference():
    """Three 2048-row tiles of a random 8×256 net at SB 32 (192 rays),
    tile 1 dead."""
    cfg = j_load_config("blender_lego", BW)
    tree = init_field(jax.random.PRNGKey(3), cfg.model)
    pack, hoist_dirs, _, eval_block, rpt_of = make_block_evaluator(cfg)
    SB = 32
    R = 3 * rpt_of(SB)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.2, 1.2, (R, SB, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    alive = np.array([[1.0], [0.0], [1.0]], np.float32)
    packed = pack(tree)
    rgb_j, sig_j = eval_block(packed, hoist_dirs(packed, jnp.asarray(dirs)),
                              None, jnp.asarray(pts), jnp.asarray(alive))
    rgb_j = np.asarray(rgb_j).reshape(-1, 3)
    sig_j = np.asarray(sig_j).reshape(-1)
    net = posenc_mlp.pack_params(load_flax_params(
        jax.device_get(tree), compute_dtype="bfloat16"), hoist_x=False)
    with torch.no_grad():
        rgb_t, sig_t = posenc_mlp.field_rows_plain(
            net, torch.from_numpy(pts.reshape(-1, 3)),
            posenc_mlp.hoist_dirs(net, torch.from_numpy(dirs)), SB,
            alive=torch.from_numpy(alive[:, 0]))
    rgb_t, sig_t = rgb_t.numpy(), sig_t.numpy()
    dead = np.repeat(alive[:, 0] <= 0, 2048)
    np.testing.assert_array_equal(rgb_t[dead], 0.0)
    np.testing.assert_array_equal(rgb_j[dead], 0.0)
    np.testing.assert_array_equal(sig_t[dead], posenc_mlp.DEAD_SIGMA)
    np.testing.assert_array_equal(sig_j[dead], np.float32(-1e10))
    np.testing.assert_allclose(rgb_t[~dead], rgb_j[~dead], atol=5e-3)
    assert np.all(np.abs(sig_t[~dead] - sig_j[~dead])
                  <= 2e-2 * (1 + np.abs(sig_j[~dead])))


@pytest.fixture(scope="module")
def flagship():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    return loaded[0]


def _opaque(tree, shift=20.0):
    """The trained net with its σ bias raised: every ray through the
    object saturates within its first block, so termination is real."""
    p = jax.tree_util.tree_map(np.array, tree)
    p["params"]["sigma_head"]["bias"] = p["params"]["sigma_head"]["bias"] \
        + np.float32(shift)
    return p


@pytest.mark.parametrize("eps,prop,opaque", [
    (1e-3, False, False), (1e-3, False, True), (0.0, False, True),
    (1e-3, True, False)])
def test_render_rays_two_stage_matches_reference(flagship, eps, prop,
                                                 opaque):
    """128 rays of a fan across the object; `opaque` raises the nets' σ
    bias and takes 64 coarse samples, two blocks, so that every ray
    terminates in the coarse march's first block (at ε 1e-3 its second
    block's tiles are then dead)."""
    ovr = BW + [f"kernels.early_term_eps={eps}"] + (
        ["sampling.n_coarse=64"] if opaque else [])
    cfg_j, cfg_t = j_load_config("blender_lego", ovr), load_config(
        "blender_lego", ovr)
    if opaque:
        flagship = {k: _opaque(flagship[k]) for k in ("coarse", "fine")}
    params_j = {k: flagship[k] for k in ("coarse", "fine")}
    params_t = {k: load_flax_params(flagship[k], compute_dtype="bfloat16")
                for k in ("coarse", "fine")}
    if prop:
        params_j = j_attach(cfg_j, params_j, allow_distill=False)
        params_t = attach_proposal(cfg_t, {"fine": params_t["fine"]},
                                   allow_distill=False)
        assert "proposal" in params_j and "proposal" in params_t
    ro, rd = _fan()
    out_j = jbw.render_rays_blockwise(params_j, cfg_j, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(rd))
    with torch.no_grad():
        out_t = tbw.render_rays_blockwise(
            params_t, cfg_t, torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(rd))
    rgb_j = torch.from_numpy(np.array(out_j["fine"]["rgb"]))
    assert float(psnr(out_t["fine"]["rgb"], rgb_j)) >= 40.0
    np.testing.assert_allclose(out_t["fine"]["acc"].numpy(),
                               np.asarray(out_j["fine"]["acc"]), atol=2e-2)
    for k in ("coarse", "fine"):
        assert float(out_t[k]["alive_frac"]) == float(out_j[k]["alive_frac"])
    assert out_t["fine"]["acc"].numpy().max() > 0.9
    assert (float(out_t["coarse"]["alive_frac"]) < 1.0) == (
        opaque and eps > 0)


# a small llff_fern: the widths of tests/integration/test_ndc_training.py
LLFF = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=4",
        "model.posenc_dir=2", "sampling.n_coarse=16", "sampling.n_fine=16",
        "kernels.interpret=true", "model.skips="]


@pytest.mark.parametrize("H,W", [(16, 24), (16, 16)])
def test_render_image_ndc_matches_reference(H, W):
    cfg_j, cfg_t = j_load_config("llff_fern", LLFF), load_config(
        "llff_fern", LLFF)
    assert cfg_t.render.ndc and not cfg_t.kernels.fused_carry
    params = jax.device_get(j_create(cfg_j, jax.random.PRNGKey(1)).params)
    nets = {k: load_flax_params(params[k], compute_dtype="bfloat16")
            for k in ("coarse", "fine")}
    focal = 0.6 * W
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.05, -0.03, 0.1]
    img_j = jbw.render_image_blockwise(params, cfg_j, H, W, focal,
                                       jnp.asarray(c2w))
    with torch.no_grad():
        img_t = tbw.render_image_blockwise(nets, cfg_t, H, W, focal, c2w)
    rgb_j = torch.from_numpy(np.array(img_j["rgb"]))
    assert img_t["rgb"].shape == (H, W, 3)
    assert float(psnr(img_t["rgb"], rgb_j)) >= 40.0
    np.testing.assert_allclose(img_t["depth"].numpy(),
                               np.asarray(img_j["depth"]), atol=2e-2)
    assert float(img_t["rgb"].std()) > 1e-3
