"""The generic carry march (K6's plain version,
fashion_nerf_torch.kernels.carrymarch) against the reference's
`_marched_pass_carry` → `_carry_eval` in interpret mode, and against the
port's slim march (K2's plain version) on the same inputs, as
tests/kernels/test_slimmarch.py holds the reference's two marches (its
conditioned case is in tests/test_torch_conditioned.py).

One pass of 256 rays × 64 samples (two blocks of 32) over [2, 6]. Random
8×256 nets are held to 2e-3, the trained flagship net to 5e-2 (the
reference's cross-path bound: a 1-ulp bf16 flip of an activation, which
the trained weights amplify); predication to equal executed-(tile, block)
fractions, reconstructed from the weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config
from fashion_nerf.core.occupancy import ray_aabb_intersect
from fashion_nerf.core.sampling import stratified_sample
from fashion_nerf.kernels.posenc_mlp_pallas import make_block_evaluator
from fashion_nerf.render.blockwise import _marched_pass_carry
from fashion_nerf_torch.core.occupancy import box_segments
from fashion_nerf_torch.kernels import carrymarch, slimmarch
from fashion_nerf_torch.kernels.posenc_mlp import hoist_dirs, pack_params
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)

R, N = 256, 64
KEYS = ("rgb", "depth", "acc", "weights")


def _cfg(eps=0.0):
    return load_config("blender_lego", [
        "kernels.use_pallas=true", "kernels.interpret=true",
        "kernels.fused_carry=true", f"kernels.early_term_eps={eps}",
        "sampling.n_coarse=32", f"sampling.n_fine={N}",
        "render.eval_n_coarse=0", "render.eval_n_fine=0",
        "proposal.enabled=false", "occupancy.enabled=false"])


def random_tree(seed, W=256, L=10):
    """Flagship-shaped random field (8×256, skip after layer 4) from a
    numpy seed, in the reference's parameter tree: LeCun-normal kernels and
    zero biases, as the reference's `init_field` draws them."""
    rng = np.random.default_rng(seed)
    cx, cd = 3 * (2 * L + 1), 27
    shapes = {f"trunk_{i}": ((cx + W) if i == 5 else (cx if i == 0 else W),
                             W) for i in range(8)}
    shapes.update(sigma_head=(W, 1), feature=(W, W), view_0=(W + cd, W // 2),
                  rgb_head=(W // 2, 3))
    return {"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32),
            "bias": np.zeros(o, np.float32)}
        for name, (i, o) in shapes.items()}}


def _inputs():
    ang = np.linspace(-0.45, 0.45, R).astype(np.float32)
    ro = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (R, 1))
    rd = np.stack([np.sin(ang), np.zeros_like(ang), -np.cos(ang)], -1)
    t = np.asarray(stratified_sample(jax.random.PRNGKey(0), 2.0, 6.0, R, N,
                                     perturb=False))
    # macro-box style segments (a ±0.9 box) so block_hit predication runs
    near, far, hit = ray_aabb_intersect(jnp.asarray(ro), jnp.asarray(rd),
                                        jnp.full((3,), -0.9),
                                        jnp.full((3,), 0.9), 2.0, 6.0)
    seg = tuple(np.asarray(x)[:, None] for x in (near, far, hit))
    return ro, rd.astype(np.float32), t, seg, np.asarray(hit)


def _box(ro, rd):
    """The port's handle of the same ±0.9 box: the marches recompute the
    reference's segments from it."""
    return box_segments(ro, rd, torch.full((1, 3), -0.9),
                        torch.full((1, 3), 0.9), 2.0, 6.0)


def _reference(tree, cfg, ro, rd, t, seg=None, alive0=None):
    pack, hdirs, _hc, _eb, _rpt = make_block_evaluator(cfg)
    packed = pack(tree)
    ro_j, rd_j = jnp.asarray(ro), jnp.asarray(rd)
    alive = (jnp.ones((R,), bool) if alive0 is None
             else jnp.asarray(alive0))
    out = _marched_pass_carry(
        packed, hdirs(packed, rd_j), None, ro_j, rd_j, jnp.asarray(t),
        jnp.linalg.norm(rd_j, axis=-1, keepdims=True), alive, cfg,
        t_end=6.0, seg=None if seg is None else tuple(map(jnp.asarray, seg)))
    return {k: np.asarray(v) for k, v in out.items()}


def _port(model, cfg, ro, rd, t, seg=None, alive0=None, slim=False):
    ro_t, rd_t, t_t = map(torch.tensor, (ro, rd, t))
    alive = (torch.ones(R, dtype=torch.bool) if alive0 is None
             else torch.tensor(alive0))
    seg_t = None if seg is None else _box(ro_t, rd_t)
    dnorm = torch.linalg.norm(rd_t, dim=-1, keepdim=True)
    with torch.no_grad():
        if slim:
            net = slimmarch.split_hoist(model)
            out = tbw.marched_pass_slim(
                net, hoist_dirs(net, rd_t),
                slimmarch.hoist_rays(net, ro_t, rd_t), t_t, dnorm, alive,
                cfg, 6.0, seg=seg_t)
        else:
            net = pack_params(model, hoist_x=False)
            out = tbw.marched_pass_carry(net, hoist_dirs(net, rd_t), ro_t,
                                         rd_t, t_t, dnorm, alive, cfg, 6.0,
                                         seg=seg_t)
    # N is two whole blocks, so the weights are the march's unpadded ones
    SB = cfg.kernels.block_samples
    bhit = tbw._block_hit_flags(t_t, SB, seg_t)
    return {**out, **tbw.march_liveness(out["weights"], alive.float(), bhit,
                                        cfg)}


def _close(a, b, atol):
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def nets():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    tree = random_tree(1)
    return {"random": (tree, load_flax_params(tree, "bfloat16")),
            "trained": (loaded[0]["fine"],
                        load_flax_params(loaded[0]["fine"], "bfloat16"))}


@pytest.fixture(scope="module")
def runs(nets):
    """Reference and port outputs: both nets without culling at ε = 0, and
    the trained net with macro segments, culled rays and ε = 1e-3."""
    ro, rd, t, seg, hit = _inputs()
    out = {}
    for name, (tree, model) in nets.items():
        cfg = _cfg()
        out[name] = (_reference(tree, cfg, ro, rd, t),
                     _port(model, cfg, ro, rd, t),
                     _port(model, cfg, ro, rd, t, slim=True))
    tree, model = nets["trained"]
    cfg = _cfg(1e-3)
    out["culled"] = (_reference(tree, cfg, ro, rd, t, seg, hit),
                     _port(model, cfg, ro, rd, t, seg, hit),
                     _port(model, cfg, ro, rd, t, seg, hit, slim=True))
    return out


@pytest.mark.parametrize("case,atol", [("random", 2e-3), ("trained", 5e-2),
                                       ("culled", 5e-2)])
def test_carry_march_plain_matches_reference(runs, case, atol):
    ref, port, _ = runs[case]
    _close(port, ref, atol)
    assert float(port["alive_frac"]) == float(ref["alive_frac"])
    assert float(port["ideal_frac"]) == float(ref["ideal_frac"])


def test_culled_case_has_dead_and_live_pairs(runs):
    _, port, _ = runs["culled"]
    live = port["tile_alive"]
    assert bool(live.any()) and not bool(live.all())
    assert float(port["acc"].max()) > 0.9


@pytest.mark.parametrize("case,atol", [("random", 2e-3), ("trained", 5e-2),
                                       ("culled", 5e-2)])
def test_carry_march_matches_slim_march(runs, case, atol):
    """The port's two marches on the same nets and inputs: the reference's
    K2-against-K6 bounds, identical executed (tile, block) pairs."""
    _, carry, slim = runs[case]
    _close(carry, slim, atol)
    assert torch.equal(carry["tile_alive"], slim["tile_alive"])


def test_dead_rays_write_zeros(nets):
    """No live ray: every weight is exactly 0, rgb the white background."""
    _, model = nets["random"]
    ro, rd, t, _, _ = _inputs()
    out = _port(model, _cfg(), ro, rd, t, alive0=np.zeros(R, bool))
    assert torch.equal(out["weights"], torch.zeros_like(out["weights"]))
    assert torch.equal(out["acc"], torch.zeros_like(out["acc"]))
    torch.testing.assert_close(out["rgb"], torch.ones_like(out["rgb"]),
                               rtol=0, atol=1e-6)
    assert float(out["alive_frac"]) == 0.0


def test_carry_march_plain_carry_is_log_transmittance(nets):
    """The plain version's carry is the log of the transmittance left after
    the last block: exp(logT) = 1 − acc (telescoping weights)."""
    _, model = nets["random"]
    ro, rd, t, _, _ = _inputs()
    net = pack_params(model, hoist_x=False)
    tt = torch.tensor(t)
    d = torch.full_like(tt, 4.0 / N)
    dp = hoist_dirs(net, torch.tensor(rd))
    rgb, depth, acc, w, logT = carrymarch.carry_march_plain(
        net, dp, torch.tensor(ro), torch.tensor(rd), torch.ones(R),
        torch.ones(R, 2), tt, d, -1e30)
    torch.testing.assert_close(acc, w.sum(1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.exp(logT), 1.0 - acc, rtol=0,
                               atol=2e-5)
    assert rgb.shape == (R, 3) and depth.shape == (R,)
