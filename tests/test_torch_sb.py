"""The marches at every SB the reference takes, on the CPU.

- The shape checks of K1, K2 and K6 (`kernels.march_sb_ok`,
  `sigmamarch.check_march_shape`, `carrymarch.check_shapes`) take exactly
  the reference's domain: powers of two whose tile of tile_rows // SB
  rays is a multiple of its row interleave (`_INTERLEAVE`,
  sigmamarch_pallas.py:160-162, slimmarch_pallas.py:255,
  blockmarch_pallas.py:183-191), so 1..512 at the tile of 2048 rows and
  1..256 at the conditioned tile of 1024; SB 24 and 1024 are refused at
  both.
- The plain K1, K2 and K6 at SB 8, 128 and 256 against the reference's
  Pallas marches in interpret mode, one predication tile each (2048 rows:
  256, 16 and 8 rays), on small random nets, at the reference's
  cross-path tolerances: K1 w/acc 2e-3 (tests/kernels/test_sigmamarch.py
  :86-88), K2 rgb/depth/acc/weights 5e-3 and K6 2e-3 on random nets
  (tests/kernels/test_slimmarch.py). A culled ray sits inside each live
  tile, which both sides march whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.kernels.posenc_mlp_pallas import (_INTERLEAVE,
                                                    make_block_evaluator)
from fashion_nerf.kernels.sigmamarch_pallas import hoist_rays as j_hoist_sig
from fashion_nerf.kernels.sigmamarch_pallas import pack_sigma as j_pack_sig
from fashion_nerf.models.nerf_mlp import init_field
from fashion_nerf.models.proposal import proposal_model_config
from fashion_nerf.render.blockwise import (_marched_pass_carry,
                                           _marched_pass_slim,
                                           _sigma_march_pass)
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.kernels import carrymarch, sigmamarch, slimmarch
from fashion_nerf_torch.kernels.posenc_mlp import hoist_dirs, pack_params
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)

# small nets: a 3×64 L = 4 field with a skip and a view branch, a 2×64
# L = 4 proposal
SMALL = ("kernels.use_pallas=true", "kernels.interpret=true",
         "kernels.fused_carry=true", "model.net_depth=3",
         "model.net_width=64", "model.posenc_xyz=4", "model.skips=1",
         "proposal.net_width=64", "proposal.posenc_xyz=4",
         "kernels.early_term_eps=1e-3")


def _reference_rule(SB, tile_rows):
    """The reference's assertion on a march's SB, on the SBs of its
    domain (powers of two up to the tile)."""
    return (SB & (SB - 1)) == 0 and (tile_rows // SB) % _INTERLEAVE == 0


@pytest.mark.parametrize("tile_rows", [2048, 1024])
def test_shape_checks_take_the_reference_domain(tile_rows):
    pows = [2 ** i for i in range(13)]
    took = [sb for sb in pows if K.march_sb_ok(sb, tile_rows)]
    assert took == [sb for sb in pows if _reference_rule(sb, tile_rows)
                    and sb <= tile_rows]
    assert took == [2 ** i for i in range(10 if tile_rows == 2048 else 9)]
    for sb in (24, 1024, 3, 0):
        assert not K.march_sb_ok(sb, tile_rows)
        with pytest.raises(ValueError):
            sigmamarch.check_march_shape(64 * tile_rows, sb, 256, 256,
                                         tile_rows)
    for sb in took:
        sigmamarch.check_march_shape(4 * (tile_rows // sb), sb, 256, 256,
                                     tile_rows)
        with pytest.raises(ValueError):   # not whole tiles
            sigmamarch.check_march_shape(tile_rows // sb + 1, sb, 256, 256,
                                         tile_rows)


def test_wrapper_checks_take_the_domain():
    """The checks each wrapper runs before a launch: K1 (and K2 serving
    the σ march above width 128), K2 and K6, at the flagship's tile."""
    tree = jax.device_get(init_field(jax.random.PRNGKey(0),
                                     j_load_config("blender_lego",
                                                   list(SMALL)).model))
    model = load_flax_params(tree, compute_dtype="bfloat16")
    fnet = pack_params(model, hoist_x=False)
    snet = slimmarch.split_hoist(model)
    for sb in (1, 8, 128, 256, 512):
        R = 2 * (K.TILE_ROWS // sb)
        carrymarch.check_shapes(fnet, R, sb)
        slimmarch.check_shapes(snet, R, sb)
    for sb in (24, 1024):
        R = 2 * max(1, K.TILE_ROWS // sb)
        with pytest.raises(ValueError):
            carrymarch.check_shapes(fnet, R, sb)
        with pytest.raises(ValueError):
            slimmarch.check_shapes(snet, R, sb)


def _random_tree(shapes_of, seed):
    """A parameter tree shaped like `shapes_of` (the reference's init):
    LeCun-normal kernels, N(0, 0.1²) biases, and the σ lane's bias at +0.5
    so that σ > 0 on a good share of the samples."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in shapes_of["params"].items():
        k = np.asarray(leaf["kernel"])
        b = (0.1 * rng.normal(size=np.shape(leaf["bias"]))).astype(np.float32)
        if name == "sigma_head":
            b[0] = 0.5
        elif name == "out_head":
            b[3] = 0.5
        out[name] = {"kernel": (rng.normal(size=k.shape) / np.sqrt(
            k.shape[0])).astype(np.float32), "bias": b}
    return {"params": out}


def _fan(R, z=4.0, spread=0.3):
    ang = np.linspace(-spread, spread, R).astype(np.float32)
    ro = np.broadcast_to(np.array([0.0, 0.0, z], np.float32), (R, 3)).copy()
    rd = np.stack([np.sin(ang), 0.05 * np.cos(3 * ang), -np.cos(ang)],
                  -1).astype(np.float32)
    return ro, rd


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(R, S):
    ro, rd = _fan(R)
    t = np.broadcast_to(np.linspace(2.0, 6.0, S, dtype=np.float32),
                        (R, S)).copy()
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True)
    alive = np.ones(R, bool)
    alive[R // 2] = False          # a culled ray inside the live tile
    return ro, rd, t, dnorm, alive


@pytest.mark.parametrize("SB", [8, 128, 256])
def test_k1_plain_every_sb(SB):
    jcfg = j_load_config("blender_lego", list(SMALL))
    cfg = load_config("blender_lego", list(SMALL))
    R = K.TILE_ROWS // SB
    ro, rd, t, dnorm, alive = _inputs(R, SB)
    pm = proposal_model_config(jcfg)
    tree = _random_tree(jax.device_get(init_field(jax.random.PRNGKey(0),
                                                  pm)), SB)
    Wx, b0, arrs, n_plain = j_pack_sig(tree, pm)
    hz = j_hoist_sig(Wx, b0, jnp.asarray(ro), jnp.asarray(rd), pm.posenc_xyz)
    out_j = _sigma_march_pass((Wx, b0, arrs, n_plain, hz), jnp.asarray(ro),
                              jnp.asarray(rd), jnp.asarray(t),
                              jnp.asarray(dnorm), jnp.asarray(alive), jcfg,
                              6.0, L=pm.posenc_xyz, sb=SB)
    net = sigmamarch.pack_sigma(load_flax_params(tree,
                                                 compute_dtype="bfloat16"))
    with torch.no_grad():
        out_t = tbw.sigma_march_pass(
            net, sigmamarch.hoist_rays(net, _t(ro), _t(rd)), _t(t),
            _t(dnorm), _t(alive), cfg, 6.0, sb=SB)
    for k in ("weights", "acc"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-3, err_msg=k)
    assert float(out_t["acc"].max()) > 1e-2


def _field_case(SB, NB):
    jcfg = j_load_config("blender_lego", list(SMALL) + [
        f"kernels.block_samples={SB}"])
    cfg = load_config("blender_lego", list(SMALL) + [
        f"kernels.block_samples={SB}"])
    R = K.TILE_ROWS // SB
    tree = _random_tree(jax.device_get(init_field(jax.random.PRNGKey(0),
                                                  jcfg.model)), 100 + SB)
    model = load_flax_params(tree, compute_dtype="bfloat16")
    return jcfg, cfg, tree, model, _inputs(R, NB * SB)


@pytest.mark.parametrize("SB,NB", [(8, 4), (128, 2), (256, 1)])
def test_k2_plain_every_sb(SB, NB):
    jcfg, cfg, tree, model, (ro, rd, t, dnorm, alive) = _field_case(SB, NB)
    pack, hoist_dirs_j = make_block_evaluator(jcfg)[:2]
    packed = pack(tree)
    out_j = _marched_pass_slim(packed, hoist_dirs_j(packed, jnp.asarray(rd)),
                               None, jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t), jnp.asarray(dnorm),
                               jnp.asarray(alive), jcfg, 6.0)
    net = slimmarch.split_hoist(model)
    with torch.no_grad():
        out_t = tbw.marched_pass_slim(
            net, hoist_dirs(net, _t(rd)),
            slimmarch.hoist_rays(net, _t(ro), _t(rd)), _t(t), _t(dnorm),
            _t(alive), cfg, 6.0)
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=5e-3, err_msg=k)
    assert float(out_t["acc"].max()) > 1e-2


@pytest.mark.parametrize("SB,NB", [(8, 4), (128, 2), (256, 1)])
def test_k6_plain_every_sb(SB, NB):
    jcfg, cfg, tree, model, (ro, rd, t, dnorm, alive) = _field_case(SB, NB)
    pack, hoist_dirs_j = make_block_evaluator(jcfg)[:2]
    packed = pack(tree)
    rd_j = jnp.asarray(rd)
    out_j = _marched_pass_carry(packed, hoist_dirs_j(packed, rd_j), None,
                                jnp.asarray(ro), rd_j, jnp.asarray(t),
                                jnp.asarray(dnorm), jnp.asarray(alive), jcfg,
                                t_end=6.0)
    net = pack_params(model, hoist_x=False)
    with torch.no_grad():
        out_t = tbw.marched_pass_carry(net, hoist_dirs(net, _t(rd)),
                                       _t(ro), _t(rd), _t(t), _t(dnorm),
                                       _t(alive), cfg, 6.0)
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-3, err_msg=k)
    assert float(out_t["acc"].max()) > 1e-2
