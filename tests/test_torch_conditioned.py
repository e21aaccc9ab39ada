"""The port's conditioned field (the try-on presets' serving path) against
the JAX reference on the CPU: the cond rows of the fields, the packed
cond_kernel and its hoist, K3's, K2's and K6's plain versions with a cond
(the reference's Pallas kernels in interpret mode), the blockwise render
with the halved conditioned tile, the cond-aware occupancy sweep, the
conditioned-teacher proposal, the carried state (encoder and latents) and
the per-scene cond vector of both try-on presets.

The conditioned flagship is the committed flagship nets with 64 cond rows
of N(0, 0.01²) inserted at trunk_0's and the skip layer's rows [63, 127),
the reference's row layout: it keeps the trained geometry, so occupancy
culls and rays terminate. Shared reference outputs are module-scoped."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config
from fashion_nerf.core import occupancy as jocc
from fashion_nerf.core.cameras import generate_rays as j_rays
from fashion_nerf.core.sampling import stratified_sample as j_strat
from fashion_nerf.kernels.posenc_mlp_pallas import (make_block_evaluator,
                                                    make_fused_field as j_mff)
from fashion_nerf.kernels.slimmarch_pallas import hoist_rays as j_hoist_rays
from fashion_nerf.kernels.slimmarch_pallas import split_hoist as j_split
from fashion_nerf.models.nerf_mlp import make_field
from fashion_nerf.render import blockwise as jbw
from fashion_nerf.train import loop as jloop
from fashion_nerf.train.state import create_train_state as j_create_state
from fashion_nerf_torch.assets import load_params
from fashion_nerf_torch.core import occupancy as tocc
from fashion_nerf_torch.kernels import slimmarch
from fashion_nerf_torch.kernels.posenc_mlp import (hoist_cond, hoist_dirs,
                                                   make_fused_field,
                                                   pack_params)
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models import proposal as tprop
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import PROPOSAL_ASSET
from fashion_nerf_torch.render import blockwise as tbw
from fashion_nerf_torch.train import loop as tloop
from fashion_nerf_torch.train.state import state_from_params

torch.set_num_threads(2)

CC = 64                                     # viton_tryon's garment code
K3_ATOL, K3_ROW_SHARE, K3_MAX = 5e-3, 5e-3, 5e-2   # test_torch_kernels_plain
H = W = 32
FOCAL = 0.5 * W / np.tan(0.5 * 0.6911)
IMG = 40


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _c2w():
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return c2w


def cond_tree(tree, cc=CC, seed=0, scale=0.01):
    """A flagship field tree with cc cond rows of N(0, scale²) at rows
    [cx, cx + cc) of trunk_0 and of the skip layer."""
    rng = np.random.default_rng(seed)
    out = copy.deepcopy(jax.device_get(tree))
    p = out["params"]
    cx = 3 * (2 * 10 + 1)
    for name in ("trunk_0", "trunk_5"):
        k = np.asarray(p[name]["kernel"], np.float32)
        rows = rng.normal(0.0, scale, (cc, k.shape[1])).astype(np.float32)
        p[name]["kernel"] = np.concatenate([k[:cx], rows, k[cx:]])
    return out


@pytest.fixture(scope="module")
def flagship():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    params = loaded[0]
    trees = {k: cond_tree(params[k], seed=i)
             for i, k in enumerate(("coarse", "fine"))}
    prop, _ = load_params(PROPOSAL_ASSET)
    cond = np.random.default_rng(5).normal(size=(CC,)).astype(np.float32)
    models = {k: load_flax_params(v, "bfloat16", cond_dim=CC)
              for k, v in trees.items()}
    models["proposal"] = load_flax_params(prop, "bfloat16")
    return {"trees": trees, "proposal": prop, "cond": cond,
            "models": models}


def _small_cfg(preset, *ovr):
    return load_config(preset, ["kernels.interpret=true", "model.net_depth=3",
                                "model.net_width=32", "model.posenc_xyz=4",
                                "model.condition_dim=16",
                                "model.latent_dim=8", "model.n_latents=4"
                                if preset == "dynamic_tryon" else
                                "model.n_latents=0", *ovr])


@pytest.fixture(scope="module")
def small_states():
    """The reference's create_train_state of both presets, shrunk, and the
    port's state carried from its params."""
    out = {}
    for preset in ("viton_tryon", "dynamic_tryon"):
        cfg_j = _small_cfg(preset)
        st = j_create_state(cfg_j, jax.random.PRNGKey(3))
        params = jax.device_get(st.params)
        state = state_from_params(load_config(preset, [
            "model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
            "model.condition_dim=16", "model.latent_dim=8",
            "model.n_latents=" + ("4" if preset == "dynamic_tryon" else "0"),
            "model.compute_dtype=bfloat16"]), params, torch.Generator())
        out[preset] = (cfg_j, params, state)
    return out


# --------------------------------------------------------------------------
# weights carried across; the cond vector
# --------------------------------------------------------------------------

def test_state_from_params_carries_every_tree(small_states):
    """coarse/fine with their cond rows, the encoder (HWIO → OIHW) and the
    latent table land in the state, under Adam, and round-trip."""
    for preset, (cfg_j, params, state) in small_states.items():
        nets = state.nets()
        want = {"coarse", "fine", "encoder"} | (
            {"latents"} if preset == "dynamic_tryon" else set())
        assert set(nets) == want, preset
        assert nets["fine"].cond_dim == 16 + (8 if "latents" in want else 0)
        np.testing.assert_array_equal(
            nets["fine"].to_flax_params()["params"]["trunk_0"]["kernel"],
            params["fine"]["params"]["trunk_0"]["kernel"])
        k = params["encoder"]["params"]["conv_1"]["kernel"]
        np.testing.assert_array_equal(
            nets["encoder"].convs[1].weight.detach().numpy(),
            np.transpose(k, (3, 2, 0, 1)))
        n_opt = sum(p.numel() for g in state.optimizer.param_groups
                    for p in g["params"])
        assert n_opt == sum(p.numel() for p in state.parameters())


@pytest.mark.parametrize("preset", ["viton_tryon", "dynamic_tryon"])
def test_eval_cond_matches_reference(small_states, preset):
    """The per-scene cond vector: the garment code of the procedural
    pair's stack (the encoder carried from the reference) ⊕ frame 2's
    latent, at 1e-5; the garment is the reference's resolve_garment."""
    cfg_j, params, state = small_states[preset]
    rng = np.random.default_rng(7)
    garment = rng.uniform(0, 1, (64, 64, 7)).astype(np.float32)
    c_j = np.asarray(jloop._eval_cond(cfg_j, params, jnp.asarray(garment),
                                      frame_id=2))
    with torch.no_grad():
        c_t = tloop._eval_cond(cfg_j, state.nets(), _t(garment), frame_id=2)
    assert c_t.shape == c_j.shape == (16 + (8 if preset == "dynamic_tryon"
                                            else 0),)
    np.testing.assert_allclose(c_t.numpy(), c_j, atol=1e-5)


def test_resolve_garment_procedural_pair_matches_reference(small_states):
    """A conditioned config on a dataset without a garment takes the
    procedural pair's stack (with the committed matcher), 1e-4."""
    cfg_j = small_states["dynamic_tryon"][0]
    g_j = np.asarray(jloop.resolve_garment(cfg_j, {}, 64, 64))
    g_t = tloop.resolve_garment(cfg_j, {}, 64, 64)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-4)
    assert tloop.resolve_garment(load_config("blender_lego"), {}, 8, 8) \
        is None


# --------------------------------------------------------------------------
# K3 with a cond
# --------------------------------------------------------------------------

def _k3_cond(tree, cfg, cc, rows_per_ray=64, rays=32, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (rays, rows_per_ray, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 3)).astype(np.float32)
    cond = rng.normal(size=(rays, cc)).astype(np.float32)
    rgb_j, sig_j = j_mff(cfg)(tree, *map(jnp.asarray, (pts, dirs, cond)))
    model = load_flax_params(jax.device_get(tree), "bfloat16", cond_dim=cc)
    with torch.no_grad():
        rgb_t, sig_t = make_fused_field()(model, _t(pts), _t(dirs),
                                             _t(cond))
    return (np.asarray(rgb_j), np.asarray(sig_j), rgb_t.numpy(),
            sig_t.numpy())


def test_k3_plain_conditioned_small(small_states):
    """A conditioned 3×32, L = 4 field (the reference's own init): K3's
    plain version with the cond against make_fused_field in interpret mode,
    rgb 5e-3 on every row, σ 2e-2·(1 + |σ|)."""
    cfg_j, params, _ = small_states["viton_tryon"]
    rgb_j, sig_j, rgb_t, sig_t = _k3_cond(params["fine"], cfg_j, 16)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=5e-3)
    assert np.all(np.abs(sig_t - sig_j) <= 2e-2 * (1 + np.abs(sig_j)))


def test_k3_plain_conditioned_flagship(flagship):
    """The conditioned flagship at full width (trunk_0 and the skip layer
    take the cond): the trained-net bound, 5e-3 on all but 0.5% of rows,
    5e-2 everywhere; the cond moves the output."""
    cfg = load_config("blender_lego", ["kernels.interpret=true"])
    rgb_j, sig_j, rgb_t, sig_t = _k3_cond(flagship["trees"]["fine"], cfg, CC)
    err = np.abs(rgb_t - rgb_j).max(-1).reshape(-1)
    assert err.max() <= K3_MAX and (err > K3_ATOL).mean() <= K3_ROW_SHARE
    assert np.all(np.abs(sig_t - sig_j) <= 5e-2 * (1 + np.abs(sig_j)))


def test_pack_params_lifts_the_cond_rows(flagship):
    """cond_kernel is trunk_0's and the skip layer's cond rows side by side
    (the reference's pack_params); the rest packs as an unconditioned net's
    with those rows cut; hoist_cond is one f32 product rounded to bf16.
    Packed without grad, as a render packs it (under grad cond_kernel
    keeps its graph: tests/test_torch_train_cond_field.py)."""
    m = flagship["models"]["fine"]
    with torch.no_grad():
        net = pack_params(m, hoist_x=False)
    p = flagship["trees"]["fine"]["params"]
    want = np.concatenate([p["trunk_0"]["kernel"][63:127],
                           p["trunk_5"]["kernel"][63:127]], axis=1)
    np.testing.assert_array_equal(net.cond_kernel.numpy(), want)
    assert (net.n_cond, net.tile_rows) == (2, 1024)
    plain = load_flax_params(load_flagship()[0]["fine"], "bfloat16")
    ref = pack_params(plain, hoist_x=False)
    torch.testing.assert_close(net.w, ref.w, rtol=0, atol=0)
    assert ref.n_cond == 0 and ref.tile_rows == 2048
    cond = _t(np.stack([flagship["cond"]] * 4))
    got = hoist_cond(net, cond)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 512)
    packed = make_block_evaluator(load_config(
        "blender_lego", ["kernels.interpret=true"]))[0](
            flagship["trees"]["fine"])
    want_c = np.asarray(make_block_evaluator(load_config(
        "blender_lego"))[2](packed, jnp.asarray(cond.numpy())), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want_c, rtol=1e-2,
                               atol=1e-4)


# --------------------------------------------------------------------------
# K2 and K6 with a cond: the halved tile
# --------------------------------------------------------------------------

def _fan(R=256):
    ang = np.linspace(-0.45, 0.45, R).astype(np.float32)
    ro = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (R, 1))
    rd = np.stack([np.sin(ang), np.zeros_like(ang), -np.cos(ang)],
                  -1).astype(np.float32)
    return ro, rd


@pytest.fixture(scope="module")
def march_case(flagship):
    """256 fan rays × 96 samples (NB = 3 at SB = 32), ε = 1e-3, per-ray box
    segments, the conditioned flagship fine net and a cond per ray: the
    reference's slim and carry marches with their condpart."""
    cfg = load_config("blender_lego", ["kernels.interpret=true"])
    ro, rd = _fan()
    R = ro.shape[0]
    t = np.asarray(j_strat(None, 2.0, 6.0, R, 96, perturb=False))
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True)
    lo, hi, hit = jocc.ray_aabb_intersect(jnp.asarray(ro), jnp.asarray(rd),
                                          jnp.full((3,), -0.9),
                                          jnp.full((3,), 0.9), 2.0, 6.0)
    seg = (lo[:, None], hi[:, None], hit[:, None])
    conds = np.random.default_rng(9).normal(size=(R, CC)).astype(np.float32)
    pack, hdirs, hcond = make_block_evaluator(cfg)[:3]
    packed = pack(flagship["trees"]["fine"])
    dirpart = hdirs(packed, jnp.asarray(rd))
    condpart = hcond(packed, jnp.asarray(conds))
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t),
            jnp.asarray(dnorm), hit, cfg, 6.0)
    out_s = jbw._marched_pass_slim(packed, dirpart, condpart, *args, seg=seg)
    out_c = jbw._marched_pass_carry(packed, dirpart, condpart, *args,
                                    seg=seg)
    return dict(cfg=cfg, ro=ro, rd=rd, t=t, dnorm=dnorm, hit=np.asarray(hit),
                seg=tocc.box_segments(torch.tensor(ro), torch.tensor(rd),
                                      torch.full((1, 3), -0.9),
                                      torch.full((1, 3), 0.9), 2.0, 6.0),
                packed=packed,
                condpart=np.asarray(condpart, np.float32),
                ref={"slim": {k: np.asarray(v) for k, v in out_s.items()},
                     "carry": {k: np.asarray(v) for k, v in out_c.items()}})


def _dead_pairs(w, rpt, NB=3, SB=32):
    R = w.shape[0]
    return np.all(w.reshape(R // rpt, rpt, NB, SB) == 0.0, axis=(1, 3))


def test_hoist_rays_with_cond_matches_reference(flagship, march_case):
    """K2's hoists: the cond folded into the x-intercepts oX after the
    bias, the slopes unchanged (1e-5 relative)."""
    mc = march_case
    x_kernels = j_split(mc["packed"])[1]
    cp = mc["condpart"]
    want = j_hoist_rays(x_kernels, 10, jnp.asarray(mc["ro"]),
                        jnp.asarray(mc["rd"]),
                        condpart=jnp.asarray(cp).astype(jnp.bfloat16))
    net = slimmarch.split_hoist(flagship["models"]["fine"])
    got = slimmarch.hoist_rays(net, _t(mc["ro"]), _t(mc["rd"]),
                               _t(cp).to(torch.bfloat16))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    plain = slimmarch.hoist_rays(net, _t(mc["ro"]), _t(mc["rd"]))
    assert not torch.equal(plain[2], got[2])
    torch.testing.assert_close(plain[3], got[3], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["slim", "carry"])
def test_conditioned_march_plain_halved_tile(flagship, march_case, kind):
    """K2 (cond in oX) and K6 (the cond window) with the conditioned
    flagship: the trained bound 5e-2; the executed (tile, block) pairs are
    the reference's at its halved tile of 32 rays (1024 rows), which is not
    the 64-ray tile's."""
    mc = march_case
    m = flagship["models"]["fine"]
    ro, rd, t, dnorm = map(_t, (mc["ro"], mc["rd"], mc["t"], mc["dnorm"]))
    hit = torch.from_numpy(mc["hit"])
    cp = _t(mc["condpart"]).to(torch.bfloat16)
    with torch.no_grad():
        if kind == "slim":
            net = slimmarch.split_hoist(m)
            out = tbw.marched_pass_slim(
                net, hoist_dirs(net, rd), slimmarch.hoist_rays(net, ro, rd,
                                                               cp),
                t, dnorm, hit, mc["cfg"], 6.0, seg=mc["seg"])
        else:
            net = pack_params(m, hoist_x=False)
            out = tbw.marched_pass_carry(net, hoist_dirs(net, rd), ro, rd, t,
                                         dnorm, hit, mc["cfg"], 6.0,
                                         seg=mc["seg"], condpart=cp)
    ref = mc["ref"][kind]
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=5e-2,
                                   err_msg=k)
    dead_t = _dead_pairs(out["weights"].numpy(), 32)
    np.testing.assert_array_equal(dead_t, _dead_pairs(ref["weights"], 32))
    assert dead_t.any() and not dead_t.all()
    bhit = tbw._block_hit_flags(t, 32, mc["seg"])
    live = tbw.march_liveness(out["weights"], hit.float(), bhit, mc["cfg"],
                              tile_rows=net.tile_rows)
    assert float(live["alive_frac"]) == pytest.approx(
        float(ref["alive_frac"]), abs=1e-7)
    full = tbw.march_liveness(out["weights"], hit.float(), bhit, mc["cfg"])
    assert float(full["alive_frac"]) != float(live["alive_frac"])


# --------------------------------------------------------------------------
# the blockwise render with a cond; occupancy; proposal
# --------------------------------------------------------------------------

def _viton_cfg(*ovr):
    return load_config("viton_tryon", ["kernels.interpret=true",
                                       "occupancy.resolution=32", *ovr])


@pytest.fixture(scope="module")
def scene(flagship):
    """The conditioned flagship under viton_tryon with the reference's
    cond-aware occupancy (both sides take it) and the committed proposal
    net attached on both sides."""
    cfg = _viton_cfg()
    _, field = make_field(cfg.model)
    trees, cond = flagship["trees"], flagship["cond"]
    occ_j = jocc.build_jit(cfg, field, trees["fine"], cond=jnp.asarray(cond))
    params_j = {**trees, "proposal": flagship["proposal"]}
    occ_t = tocc.OccupancyState(*[torch.tensor(np.asarray(x))
                                  for x in occ_j])
    return params_j, occ_j, flagship["models"], occ_t, cond


@pytest.mark.parametrize("hoist", ["true", "false"])
def test_render_rays_blockwise_with_cond(scene, hoist):
    """256 rays across the object, proposal (K1) + the conditioned fine
    march through K2 (cond in oX) or K6 (the cond window), each cond vector
    broadcast per ray: fine rgb ≥ 40 dB against the reference."""
    params_j, occ_j, params_t, occ_t, cond = scene
    cfg = _viton_cfg(f"kernels.carry_hoist={hoist}")
    ro, rd = j_rays(H, W, FOCAL, _c2w())
    ro = np.asarray(ro).reshape(-1, 3)[384:640]
    rd = np.asarray(rd).reshape(-1, 3)[384:640]
    conds = np.broadcast_to(cond, (256, CC))
    out_j = jbw.render_rays_blockwise(params_j, cfg, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(rd),
                                      occ=occ_j, cond=jnp.asarray(conds))
    with torch.no_grad():
        out_t = tbw.render_rays_blockwise(params_t, cfg, _t(ro), _t(rd),
                                          _t(rd), occ=occ_t, cond=_t(conds))
    p = float(psnr(out_t["fine"]["rgb"],
                   _t(np.asarray(out_j["fine"]["rgb"]))))
    assert p >= 40.0, p
    acc = out_t["fine"]["acc"].numpy()
    assert acc.max() > 0.9 and acc.min() == 0.0


def test_render_image_blockwise_with_cond(scene):
    """The slice as a whole: a 40×40 frame of the conditioned flagship in
    256-ray chunks through K1 + K2, ≥ 40 dB against the reference; another
    cond vector gives another frame."""
    params_j, occ_j, params_t, occ_t, cond = scene
    cfg = _viton_cfg("render.chunk=256")
    assert tbw.rays_per_chunk_unit(cfg) == 32
    img_j = jbw.render_image_blockwise(params_j, cfg, IMG, IMG, FOCAL,
                                       _c2w(), occ=occ_j,
                                       cond=jnp.asarray(cond))
    rgb_j = np.asarray(img_j["rgb"])
    with torch.no_grad():
        img_t = tbw.render_image_blockwise(params_t, cfg, IMG, IMG, FOCAL,
                                           _c2w(), occ=occ_t, cond=_t(cond))
        other = tbw.render_image_blockwise(params_t, cfg, IMG, IMG, FOCAL,
                                           _c2w(), occ=occ_t,
                                           cond=_t(-3.0 * cond))
    p = float(psnr(img_t["rgb"], _t(rgb_j)))
    assert p >= 40.0, p
    live = img_t["chunk_live"].numpy()
    assert live.any() and not live.all()
    assert float((other["rgb"] - img_t["rgb"]).abs().max()) > 1e-3


def test_occupancy_grid_with_cond(flagship):
    """The sweep of the conditioned fine field at the scene's cond (the
    reference's build_jit(cond=...)): ≥ 99.9% of cells agree at 32³."""
    cfg = _viton_cfg()
    _, jfield = make_field(cfg.model)
    cond = flagship["cond"]
    js = jocc.build_jit(cfg, jfield, flagship["trees"]["fine"],
                        cond=jnp.asarray(cond))
    field = make_fused_field()
    with torch.no_grad():
        ts = tocc.build_from_config(
            cfg, lambda p, v, c: field(flagship["models"]["fine"], p, v, c),
            cond=_t(cond))
    agree = float((ts.grid.numpy() == np.asarray(js.grid)).mean())
    assert agree >= 0.999, agree
    assert int(ts.grid.sum()) > 0


def test_proposal_asset_ignores_cond(flagship, tmp_path):
    """Pinned reference caveat: the asset's match carries no cond
    fingerprint, so an asset signed for these fine weights is attached
    whatever the cond (the reference's attach_proposal does the same)."""
    cfg = _viton_cfg()
    fine = flagship["models"]["fine"]
    path = str(tmp_path / "prop.npz")
    tprop.save_proposal_asset(cfg, flagship["models"]["proposal"], fine,
                              path=path)
    got = [tprop.attach_proposal(cfg, {"fine": fine}, cond=_t(c), path=path,
                                 allow_distill=False)
           for c in (flagship["cond"], -flagship["cond"])]
    for g in got:
        assert "proposal" in g
        torch.testing.assert_close(g["proposal"].trunk[0].weight,
                                   flagship["models"]["proposal"].trunk[0]
                                   .weight, rtol=0, atol=0)


def test_distillation_takes_the_cond_teacher(flagship, tmp_path):
    """Without a matching asset the proposal is distilled from the fine
    field run at the scene's cond: two conds give two students (same
    seed), and the student stays unconditioned."""
    cfg = _viton_cfg("proposal.distill_steps=2", "proposal.distill_batch=64")
    fine = flagship["models"]["fine"]
    missing = str(tmp_path / "none.npz")
    with torch.no_grad():
        pa, pb = (tprop.attach_proposal(cfg, {"fine": fine}, cond=_t(c),
                                        path=missing)["proposal"]
                  for c in (flagship["cond"], 40.0 * flagship["cond"]))
    assert pa.cond_dim == 0
    assert not torch.equal(pa.trunk[0].weight, pb.trunk[0].weight)


def test_ckpt_round_trips_encoder_and_latents(small_states, tmp_path):
    """A dynamic_tryon state saved through ckpt restores into a fresh
    template: the fields, the encoder, the latent table and Adam."""
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch.train.state import create_train_state
    cfg_j, _, state = small_states["dynamic_tryon"]
    state.step = 5
    ckpt_lib.save(str(tmp_path), state)
    fresh = create_train_state(cfg_j, torch.Generator().manual_seed(9),
                               torch.Generator())
    assert set(fresh.nets()) == set(state.nets())
    ckpt_lib.restore(str(tmp_path), fresh)
    assert fresh.step == 5
    for (name, a), b in zip(state.nets().items(), fresh.nets().values()):
        for p, q in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_load_dataset_viton_branch():
    """The viton preset's hermetic dataset: the procedural scene and the
    procedural pair's conditioning stack (with the committed matcher),
    1e-4 against the reference's load_viton_scene."""
    cfg = load_config("viton_tryon")
    d_t = tloop.load_dataset(cfg)
    from fashion_nerf.data.viton import load_viton_scene
    d_j = load_viton_scene("", cfg=cfg)
    assert d_t["garment"].shape == (64, 64, 7)
    np.testing.assert_allclose(d_t["garment"], np.asarray(d_j["garment"]),
                               atol=1e-4)
    np.testing.assert_allclose(d_t["images"], d_j["images"], atol=1e-5)
