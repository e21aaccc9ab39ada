"""Nets with several skip layers and the σ march's proposal widths, on the
CPU against the JAX reference (its Pallas kernels in interpret mode, as its
own tests run them).

- `pack_params` of a 6×64 net with skips (1, 3): the reference's plan,
  every tensor at the `_layout` offset of the reference's array, and the
  conditioned net's three cond slices (`cond_kernel`) in its order;
- K3's and K4's plain versions (through `make_fused_field`, `FusedField`)
  against the reference's fused field and its Pallas VJP on that net,
  unconditioned and conditioned (Cc 8): rgb 5e-3, σ 2e-2·(1+|σ|) (the
  random-net bound of tests/test_torch_kernels_plain.py), every gradient
  1e-3 relative RMS (as tests/test_torch_train_field.py holds one skip);
- the plain K2 and K6 marches against `_marched_pass_slim` and
  `_marched_pass_carry` on the conditioned two-skip net: weights and acc
  2e-3, rgb 5e-2 (tests/kernels/test_sigmamarch.py:86-88,
  tests/kernels/test_slimmarch.py:82-231);
- the plain σ march at the spec sweep's proposal widths, 2×192 and 3×256
  at L = 8 (scripts/quality_check.py:366-383), against `_sigma_march_pass`;
- zero padding (`pad_packed`): a two-skip field net through K3 and K4,
  and march-packed nets (the σ march's 2×192 proposal to width 256, and
  two-skip nets with a view branch, 6×64 to 128 and 8×128 to 256, through
  K2's plain version) equal to the unpadded nets.

Each reference call is jitted once and shared across its assertions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.core.occupancy import ray_aabb_intersect
from fashion_nerf.kernels.posenc_mlp_pallas import (make_block_evaluator,
                                                    make_fused_field as j_mff,
                                                    pack_params as j_pack)
from fashion_nerf.kernels.sigmamarch_pallas import hoist_rays as j_hoist_sig
from fashion_nerf.kernels.sigmamarch_pallas import pack_sigma as j_pack_sig
from fashion_nerf.models.nerf_mlp import init_field as j_init
from fashion_nerf.models.proposal import proposal_model_config
from fashion_nerf.render import blockwise as jbw
from fashion_nerf_torch.core.occupancy import box_segments
from fashion_nerf_torch.kernels import posenc_mlp, sigmamarch, slimmarch
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.render import blockwise as tbw

torch.set_num_threads(2)

SKIPS = ["kernels.interpret=true", "model.net_depth=6", "model.net_width=64",
         "model.skips=1,3", "model.posenc_xyz=4", "model.posenc_dir=2"]
PLAN = ("first", "plain", "skip", "plain", "skip", "plain", "heads_vd")
CC = 8


def _cfg(*ovr):
    return load_config("blender_lego", SKIPS + list(ovr))


def _tree(mcfg, seed, cond_dim=0):
    """The reference's init with random biases, so that a bias read at a
    wrong offset shows."""
    tree = jax.tree_util.tree_map(
        np.array, j_init(jax.random.PRNGKey(seed), mcfg, cond_dim))
    rng = np.random.default_rng(seed)
    for leaf in tree["params"].values():
        leaf["bias"] = (0.1 * rng.normal(size=leaf["bias"].shape)).astype(
            np.float32)
    return tree


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

def test_pack_params_plan_and_layout_match_reference():
    cfg = _cfg()
    tree = _tree(cfg.model, 0)
    arrs, plan, _, _ = j_pack(tree, cfg.model)
    assert plan == PLAN
    with torch.no_grad():
        net = posenc_mlp.pack_params(load_flax_params(
            tree, compute_dtype="bfloat16"), hoist_x=False)
    lay, W, L = net.lay, net.width, net.L
    assert net.skips == (2, 4) and net.skip_mask == 0b10100
    got = tuple("first" if i == 0 else "skip" if lay["w_a0"][i] is not None
                else "plain" for i in range(net.depth)) + ("heads_vd",)
    assert got == plan

    def same(off, rows, cols, ref):
        np.testing.assert_array_equal(
            net.wview(off, rows, cols).numpy(),
            np.asarray(jnp.asarray(ref, jnp.float32)))

    it = iter(arrs)
    for i, kind in enumerate(plan[:-1]):
        if kind != "first":
            same(lay["w_h"][i], W, W, next(it))
        if kind != "plain":
            a0 = net.wview(lay["w_a0"][i], net.k0, W)
            same(lay["w_a0"][i], 3, W, next(it))
            np.testing.assert_array_equal(
                a0[3:3 + 6 * L].numpy(),
                np.asarray(jnp.asarray(next(it), jnp.float32)))
            assert not bool(a0[3 + 6 * L:].any())
        np.testing.assert_array_equal(net.b[lay["b"][i]:lay["b"][i] + W],
                                      np.asarray(next(it))[0])
    for name, cols in (("sig", 1), ("feat", W), ("view", W // 2),
                       ("rgb", 3)):
        k, b = next(it), np.asarray(next(it))[0]
        rows = W // 2 if name == "rgb" else W
        same(lay["w_" + name], rows, cols, np.asarray(k)[:, :cols])
        np.testing.assert_array_equal(
            net.b[lay["b_" + name]:lay["b_" + name] + cols], b[:cols])
    assert next(it, None) is None

    # the conditioned net: one W-wide cond slice per x-layer, in order
    ctree = _tree(cfg.model, 1, CC)
    _, cplan, _, ck = j_pack(ctree, cfg.model)
    assert cplan == ("first_c", "plain", "skip_c", "plain", "skip_c",
                     "plain", "heads_vd")
    with torch.no_grad():
        cnet = posenc_mlp.pack_params(load_flax_params(
            ctree, compute_dtype="bfloat16", cond_dim=CC), hoist_x=False)
    assert cnet.n_cond == 3 and cnet.tile_rows == 1024
    np.testing.assert_array_equal(cnet.cond_kernel.numpy(), np.asarray(ck))


# --------------------------------------------------------------------------
# K3 and K4: the fused field and its VJP
# --------------------------------------------------------------------------

def _loss(rgb, sig):
    return jnp.mean(rgb ** 2) + 0.01 * jnp.mean(jax.nn.relu(sig) ** 2)


@pytest.fixture(scope="module", params=[False, True],
                ids=["uncond", "cond"])
def field_case(request):
    """The reference's fused field and its Pallas VJP (one jitted call)
    and the port's `make_fused_field` on 16 rays × 32 samples."""
    cond = request.param
    cfg = _cfg()
    tree = _tree(cfg.model, 2, CC if cond else 0)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.5, 1.5, (16, 32, 3)).astype(np.float32)
    dirs = rng.normal(size=(16, 3)).astype(np.float32)
    c = rng.normal(size=(16, CC)).astype(np.float32) if cond else None
    field = j_mff(cfg)

    def both(p, x, d, c):
        out = field(p, x, d, c)
        grads = jax.grad(lambda *a: _loss(*field(*a)),
                         argnums=(0, 1, 2, 3) if cond else (0, 1, 2))(
            p, x, d, *(() if c is None else (c,)))
        return out, grads

    if cond:
        (rgb_j, sig_j), g_j = jax.jit(both)(tree, pts, dirs, c)
    else:
        (rgb_j, sig_j), g_j = jax.jit(
            lambda p, x, d: both(p, x, d, None))(tree, pts, dirs)
    model = load_flax_params(tree, compute_dtype="bfloat16",
                             cond_dim=CC if cond else 0)
    ins = [_t(pts).requires_grad_(True), _t(dirs).requires_grad_(True)]
    if cond:
        ins.append(_t(c).requires_grad_(True))
    rgb_t, sig_t = posenc_mlp.make_fused_field()(model, *ins)
    (torch.mean(rgb_t ** 2) + 0.01 * torch.mean(torch.relu(sig_t) ** 2)
     ).backward()
    return (np.asarray(rgb_j), np.asarray(sig_j), g_j, rgb_t.detach(),
            sig_t.detach(), model, ins)


def test_k3_plain_two_skips_matches_reference(field_case):
    rgb_j, sig_j, _, rgb_t, sig_t, _, _ = field_case
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=5e-3)
    assert np.all(np.abs(sig_t.numpy() - sig_j)
                  <= 2e-2 * (1 + np.abs(sig_j)))
    assert float(rgb_t.std()) > 1e-3


def test_k4_plain_two_skips_matches_pallas_vjp(field_case):
    _, _, g_j, _, _, model, ins = field_case
    p = g_j[0]["params"]
    for name, layer in model.named_dense():
        for key, got in (("kernel", layer.weight.grad.numpy().T),
                         ("bias", layer.bias.grad.numpy())):
            want = np.asarray(p[name][key])
            assert _rel_rms(got, want) <= 1e-3, (name, key,
                                                  _rel_rms(got, want))
    for i, x in enumerate(ins):
        assert _rel_rms(x.grad.numpy(), g_j[1 + i]) <= 1e-3, i


# --------------------------------------------------------------------------
# K2 and K6: the marches
# --------------------------------------------------------------------------

R_M, S_M = 128, 64          # 2 tiles of 64 rays, NB = 2 blocks of 32


def _march_inputs():
    ang = np.linspace(-0.45, 0.45, R_M).astype(np.float32)
    ro = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (R_M, 1))
    rd = np.stack([np.sin(ang), 0.05 * np.cos(3 * ang), -np.cos(ang)],
                  -1).astype(np.float32)
    t = np.tile(np.linspace(2.0, 6.0, S_M, dtype=np.float32), (R_M, 1))
    near, far, hit = ray_aabb_intersect(jnp.asarray(ro), jnp.asarray(rd),
                                        jnp.full((3,), -0.9),
                                        jnp.full((3,), 0.9), 2.0, 6.0)
    seg = tuple(np.asarray(x)[:, None] for x in (near, far, hit))
    cond = np.random.default_rng(5).normal(size=(R_M, CC)).astype(np.float32)
    return ro, rd, t, seg, np.asarray(hit), cond


@pytest.mark.parametrize("march", ["slim", "carry"])
def test_marches_two_skips_cond_match_reference(march):
    """K2 (x-layers hoisted, cond folded into their intercepts) and K6
    (positions per sample, the cond window) on the conditioned two-skip
    net, 128 rays × 2 blocks with box segments and termination."""
    cfg = _cfg("kernels.fused_carry=true")
    tree = _tree(cfg.model, 4, CC)
    ro, rd, t, seg, hit, cond = _march_inputs()
    pack, hdirs, hcond = make_block_evaluator(cfg)[:3]
    packed = pack(tree)
    ro_j, rd_j = jnp.asarray(ro), jnp.asarray(rd)
    dn = np.linalg.norm(rd, axis=-1, keepdims=True)
    fn = jbw._marched_pass_slim if march == "slim" else \
        jbw._marched_pass_carry
    out_j = fn(packed, hdirs(packed, rd_j), hcond(packed, jnp.asarray(cond)),
               ro_j, rd_j, jnp.asarray(t), jnp.asarray(dn),
               jnp.asarray(hit), cfg, 6.0,
               seg=tuple(map(jnp.asarray, seg)))
    model = load_flax_params(tree, compute_dtype="bfloat16", cond_dim=CC)
    ro_t, rd_t = _t(ro), _t(rd)
    seg_t = box_segments(_t(ro), _t(rd), torch.full((1, 3), -0.9),
                         torch.full((1, 3), 0.9), 2.0, 6.0)
    with torch.no_grad():
        if march == "slim":
            net = slimmarch.split_hoist(model)
            assert len(net.x_kernels) == 3 and net.n_cond == 3
            cp = posenc_mlp.hoist_cond(net, _t(cond))
            out_t = tbw.marched_pass_slim(
                net, posenc_mlp.hoist_dirs(net, rd_t),
                slimmarch.hoist_rays(net, ro_t, rd_t, cp), _t(t), _t(dn),
                torch.from_numpy(hit.copy()), cfg, 6.0, seg=seg_t)
        else:
            net = posenc_mlp.pack_params(model, hoist_x=False)
            out_t = tbw.marched_pass_carry(
                net, posenc_mlp.hoist_dirs(net, rd_t), ro_t, rd_t, _t(t),
                _t(dn), torch.from_numpy(hit.copy()), cfg, 6.0, seg=seg_t,
                condpart=posenc_mlp.hoist_cond(net, _t(cond)))
    for k, tol in (("weights", 2e-3), ("acc", 2e-3), ("rgb", 5e-2)):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=tol, err_msg=k)
    assert float(out_t["acc"].max()) > 0.5


# --------------------------------------------------------------------------
# the σ march at the spec sweep's proposal widths
# --------------------------------------------------------------------------

def _prop_case(ovr, seed):
    cfg = load_config("blender_lego", ["kernels.interpret=true", *ovr])
    pm = proposal_model_config(cfg)
    return cfg, pm, _tree(pm, seed)


SWEEP = {"w192L8": ["proposal.net_width=192", "proposal.posenc_xyz=8"],
         "w256d3L8": ["proposal.net_width=256", "proposal.net_depth=3",
                      "proposal.posenc_xyz=8"]}


@pytest.mark.parametrize("which", sorted(SWEEP))
def test_sigma_march_proposal_widths_match_reference(which):
    """64 fan rays × 64 samples (two proposal tiles, one dead), weights
    and acc 2e-3; on the card this net takes K2 (`sigma_kernel`)."""
    cfg, pm, tree = _prop_case(SWEEP[which], 6)
    ro, rd, _, _, _, _ = _march_inputs()
    ro, rd = ro[:64], rd[:64]
    t = np.tile(np.linspace(2.0, 6.0, 64, dtype=np.float32), (64, 1))
    dn = np.linalg.norm(rd, axis=-1, keepdims=True)
    alive0 = np.ones(64, bool)
    alive0[:32] = False
    Wx, b0, arrs, n_plain = j_pack_sig(tree, pm)
    hz = j_hoist_sig(Wx, b0, jnp.asarray(ro), jnp.asarray(rd), pm.posenc_xyz)
    out_j = jbw._sigma_march_pass(
        (Wx, b0, arrs, n_plain, hz), jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(t), jnp.asarray(dn), jnp.asarray(alive0), cfg, 6.0,
        L=pm.posenc_xyz, sb=64)
    net = sigmamarch.pack_sigma(load_flax_params(tree,
                                                 compute_dtype="bfloat16"))
    assert (net.width, net.depth) == (pm.net_width, pm.net_depth)
    assert sigmamarch.sigma_kernel(net) == "K2"
    with torch.no_grad():
        out_t = tbw.sigma_march_pass(
            net, sigmamarch.hoist_rays(net, _t(ro), _t(rd)), _t(t), _t(dn),
            torch.from_numpy(alive0), cfg, 6.0, sb=64)
    for k in ("weights", "acc"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-3, err_msg=k)
    assert float(out_t["acc"][32:].max()) > 0.05
    assert not bool(out_t["acc"][:32].any())


# --------------------------------------------------------------------------
# zero padding
# --------------------------------------------------------------------------

def _random_model(rng, W, depth, L, skips, vd, cond_dim=0):
    """A random NeRFMLP (random biases) with `skips` (the reference's
    convention: γ(x) joins after trunk layer s)."""
    cfg = load_config("blender_lego", [
        f"model.net_depth={depth}", f"model.net_width={W}",
        f"model.posenc_xyz={L}", "model.posenc_dir=2",
        "model.skips=" + ",".join(map(str, skips)),
        f"model.use_viewdirs={'true' if vd else 'false'}"])
    return load_flax_params(_tree(cfg.model, int(rng.integers(1 << 30)),
                                  cond_dim), compute_dtype="bfloat16",
                            cond_dim=cond_dim)


def test_pad_packed_two_skip_field_net_equals_unpadded():
    """K3 and K4 plain on the two-skip 6×64 field net padded to 128/48
    against the unpadded net: outputs 1e-6, gradients (cut back) 1e-6
    relative RMS, the padding's gradients exact zeros."""
    rng = np.random.default_rng(7)
    with torch.no_grad():
        net = posenc_mlp.pack_params(_random_model(rng, 64, 6, 4, (1, 3),
                                                   True, CC), hoist_x=False)
    big = posenc_mlp.pad_packed(net)
    assert (big.width, big.k0, big.skips) == (128, 48, (2, 4))
    n, spr = 192, 3
    pts = _t(rng.uniform(-1.2, 1.2, (n, 3)))
    dp = posenc_mlp.hoist_dirs(net, _t(rng.normal(size=(n // spr, 3))))
    cp = posenc_mlp.hoist_cond(net, _t(rng.normal(size=(n // spr, CC))))
    dp_b = posenc_mlp.pad_dirpart(net, big, dp)
    cp_b = posenc_mlp.pad_condpart(net, big.width, cp)
    with torch.no_grad():
        rgb, sig = posenc_mlp.field_rows_plain(net, pts, dp, spr, cp)
        rgb_b, sig_b = posenc_mlp.field_rows_plain(big, pts, dp_b, spr, cp_b)
    assert float((rgb - rgb_b).abs().max()) <= 1e-6
    assert float((sig - sig_b).abs().max()) <= 1e-6 * (1 + float(
        sig.abs().max()))
    g_rgb, g_sig = _t(rng.normal(size=(n, 3))), _t(rng.normal(size=n))
    with torch.no_grad():
        out = posenc_mlp.field_rows_backward_plain(net, pts, dp, g_rgb,
                                                   g_sig, spr, cp)
        out_b = posenc_mlp.field_rows_backward_plain(big, pts, dp_b, g_rgb,
                                                     g_sig, spr, cp_b)
    pos_w, pos_b = big.unpad
    d_cond_b = out_b[4].reshape(n // spr, 3, big.width)[:, :, :64]
    for name, a, b in (("d_pts", out[0], out_b[0]),
                       ("d_dir", out[1], out_b[1][:, :32]),
                       ("d_w", out[2], out_b[2][pos_w]),
                       ("d_b", out[3], out_b[3][pos_b]),
                       ("d_cond", out[4], d_cond_b.reshape(n // spr, -1))):
        assert _rel_rms(a, b) <= 1e-6, name
    rest = torch.ones_like(out_b[2], dtype=torch.bool)
    rest[pos_w] = False
    assert not bool(out_b[2][rest].any())


@pytest.mark.parametrize("W,depth,L,skips,Wp", [
    (64, 6, 4, (1, 3), 128), (128, 8, 6, (2, 4), 256)])
def test_pad_packed_march_nets_equal_unpadded(W, depth, L, skips, Wp):
    """K2's plain version on a two-skip net with a view branch, packed for
    the marches and padded with zeros (6×64 to 128, the width
    `slimmarch.march_net` gives it on the card; 8×128 to 256), hoists and
    view term widened with zero columns (`pad_hoists`, `pad_dirpart`),
    against the unpadded net: rgb, weights and transmittance 1e-6."""
    rng = np.random.default_rng(W)
    with torch.no_grad():
        net = slimmarch.split_hoist(_random_model(rng, W, depth, L, skips,
                                                  True))
    big = posenc_mlp.pad_packed(net, Wp)
    assert (big.width, big.k0, big.skips, big.x_rows) == (
        Wp, net.k0, net.skips, False)
    if W == 64:
        assert slimmarch.march_net(net).width == Wp
    else:                 # K2 is built at 128: it takes the net as it is
        assert slimmarch.march_net(net) is net
    R, NB, SB = 64, 2, 32
    ro = _t(np.tile([0.0, 0.0, 4.0], (R, 1)))
    rd = _t(np.stack([rng.uniform(-0.3, 0.3, R), rng.uniform(-0.3, 0.3, R),
                      -np.ones(R)], -1))
    t = _t(np.tile(np.linspace(2.0, 6.0, NB * SB), (R, 1)))
    d = torch.full((R, NB * SB), 4.0 / (NB * SB))
    hit, bhit = torch.ones(R), torch.ones((R, NB))
    hz = slimmarch.hoist_rays(net, ro, rd)
    dp = posenc_mlp.hoist_dirs(net, rd)
    with torch.no_grad():
        out = slimmarch.slim_march_plain(net, hz, dp, hit, bhit, t, d, -6.9)
        out_b = slimmarch.slim_march_plain(
            big, slimmarch.pad_hoists(net, big, hz),
            posenc_mlp.pad_dirpart(net, big, dp), hit, bhit, t, d, -6.9)
    for a, b in zip(out, out_b):
        assert float((a - b).abs().max()) <= 1e-6
    assert float(out[1].sum()) > 0.0


def test_pad_packed_sigma_net_equals_unpadded():
    """The σ march's plain version on the sweep's 2×192 proposal and on it
    padded to 256 (what K2 runs on the card): w, acc and logT 1e-6."""
    _, pm, tree = _prop_case(SWEEP["w192L8"], 8)
    net = sigmamarch.pack_sigma(load_flax_params(tree,
                                                 compute_dtype="bfloat16"))
    big = slimmarch.march_net(net)
    assert (big.width, big.k0, big.L) == (256, net.k0, 8)
    R, SB = 64, 64
    rng = np.random.default_rng(9)
    ro = _t(np.tile([0.0, 0.0, 4.0], (R, 1)))
    rd = _t(np.stack([rng.uniform(-0.3, 0.3, R), rng.uniform(-0.3, 0.3, R),
                      -np.ones(R)], -1))
    t = _t(np.tile(np.linspace(2.0, 6.0, SB), (R, 1)))
    d = torch.full((R, SB), 4.0 / SB)
    alive = torch.ones(R)
    hz = sigmamarch.hoist_rays(net, ro, rd)
    hz_b = slimmarch.pad_hoists(net, big, hz)
    assert torch.equal(hz_b[2][:, :192], hz[2]) and not bool(
        hz_b[2][:, 192:].any())
    with torch.no_grad():
        out = sigmamarch.sigma_march_plain(net, hz, alive, t, d)
        out_b = sigmamarch.sigma_march_plain(big, hz_b, alive, t, d)
    for a, b in zip(out, out_b):
        assert float((a - b).abs().max()) <= 1e-6
