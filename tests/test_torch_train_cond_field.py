"""The conditioned field's gradient path on the CPU (K4's dcond output):
`FusedField` with a condpart (K3 forward and K4 backward, here their plain
versions) against the reference's fused VJP with a cond (`make_fused_field`
→ `_pallas_backward`, Pallas in interpret mode), by reference layer name.

Every gradient, the cond's and the cond rows of trunk_0 and of the skip
layer included, must sit in the reference's envelope around f32 truth
(RMS error ≤ 2.5× the bf16 XLA field's, +1e-4·scale;
tests/kernels/test_posenc_mlp.py:229-234) and within 1e-3 relative RMS of
the reference's Pallas gradient at width 32, 2e-3 at width 256 (the
unconditioned K4's bound). The plain K4's d_condpart is also held to the
reference's per-ray sum of its dcond rows directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.kernels import posenc_mlp_pallas as jpal
from fashion_nerf.models.nerf_mlp import init_field as j_init
from fashion_nerf.models.nerf_mlp import make_field
from fashion_nerf_torch.kernels import posenc_mlp
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

torch.set_num_threads(2)

SMALL = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
         "model.skips=1"]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _loss(rgb, sig, relu):
    return (rgb ** 2).mean() + 0.01 * (relu(sig) ** 2).mean()


def _grads_j(field, args):
    def f(p, x, d, c):
        rgb, sig = field(p, x, d, c)
        return _loss(rgb, sig, jax.nn.relu)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*args)


@pytest.mark.parametrize("overrides,R,S,cc,tol", [
    (SMALL, 16, 8, 16, 1e-3),
    (SMALL + ["model.use_viewdirs=false"], 16, 8, 16, 1e-3),
    ([], 256, 1, 64, 2e-3),                # the sparsity prior's spr = 1
    ([], 4, 64, 64, 2e-3),
], ids=["small", "small_no_viewdirs", "full_width_spr1", "full_width"])
def test_fused_field_cond_gradients_match_reference(overrides, R, S, cc,
                                                    tol):
    cfg = load_config("blender_lego", ["kernels.interpret=true"] + overrides)
    params = j_init(jax.random.PRNGKey(0), cfg.model, cc)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    cond = rng.normal(size=(R, cc)).astype(np.float32)
    args = (params, *map(jnp.asarray, (pts, dirs, cond)))
    g_pal = _grads_j(jpal.make_fused_field(cfg), args)
    g_bf = _grads_j(make_field(cfg.model)[1], args)
    f32 = load_config("blender_lego",
                      overrides + ["model.compute_dtype=float32"])
    with jax.default_matmul_precision("highest"):
        g_f32 = _grads_j(make_field(f32.model)[1], args)

    model = load_flax_params(jax.device_get(params), "bfloat16", cond_dim=cc)
    x, d, c = (torch.from_numpy(a).requires_grad_(True)
               for a in (pts, dirs, cond))
    rgb, sig = posenc_mlp.make_fused_field()(model, x, d, c)
    _loss(rgb, sig, torch.relu).backward()

    cx = 3 * (2 * cfg.model.posenc_xyz + 1)
    skip = [f"trunk_{s + 1}" for s in cfg.model.skips
            if s + 1 < cfg.model.net_depth][0]

    def leaf(tree, name, kind):
        return np.asarray(tree["params"][name][kind])

    cases = []
    for name, layer in model.named_dense():
        for kind, g in (("kernel", layer.weight.grad.numpy().T),
                        ("bias", layer.bias.grad.numpy())):
            cases.append(((name, kind), g, *(leaf(t[0], name, kind)
                                             for t in (g_pal, g_bf, g_f32))))
    for name in ("trunk_0", skip):                  # the cond rows alone
        rows = slice(cx, cx + cc)
        g = model.get_submodule(f"trunk.{name[6:]}").weight.grad.numpy().T
        cases.append(((name, "cond rows"), g[rows],
                      *(leaf(t[0], name, "kernel")[rows]
                        for t in (g_pal, g_bf, g_f32))))
    for i, (key, t) in enumerate((("pts", x), ("viewdirs", d),
                                  ("cond", c))):
        if key == "viewdirs" and not cfg.model.use_viewdirs:
            continue
        cases.append(((key,), t.grad.numpy(),
                      *(np.asarray(g[i + 1]) for g in (g_pal, g_bf, g_f32))))
    for key, g, p, b, t in cases:
        scale = _rms(t) + 1e-12
        assert _rms(g - t) <= 2.5 * _rms(b - t) + 1e-6 + 1e-4 * scale, key
        assert _rms(g - p) <= tol * (_rms(p) + 1e-12), (key, _rms(g - p)
                                                         / _rms(p))
    assert float(np.abs(c.grad.numpy()).max()) > 0.0


def test_plain_k4_dcondpart_is_the_reference_dcond_summed_per_ray():
    """field_rows_backward_plain's fifth output against the reference
    kernel's own dcond rows (`_fused_bwd_eval`, interpret mode) summed over
    each ray's samples, on the small net with a skip: 1e-3 relative RMS;
    the other four outputs are those of the unconditioned call's shape."""
    cfg = load_config("blender_lego", ["kernels.interpret=true"] + SMALL)
    cc, R, S = 16, 16, 8
    params = j_init(jax.random.PRNGKey(2), cfg.model, cc)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (R * S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    cond = rng.normal(size=(R, cc)).astype(np.float32)
    g_rgb = rng.normal(size=(R * S, 3)).astype(np.float32)
    g_sig = rng.normal(size=(R * S,)).astype(np.float32)

    model = load_flax_params(jax.device_get(params), "bfloat16", cond_dim=cc)
    with torch.no_grad():
        net = posenc_mlp.pack_params(model, hoist_x=False)
        dp = posenc_mlp.hoist_dirs(net, torch.from_numpy(dirs))
        cp = posenc_mlp.hoist_cond(net, torch.from_numpy(cond))
        out = posenc_mlp.field_rows_backward_plain(
            net, torch.from_numpy(pts), dp, torch.from_numpy(g_rgb),
            torch.from_numpy(g_sig), S, cp)
    assert len(out) == 5 and out[4].shape == (R, 2 * 32)

    arrs, plan, _, _ = jpal.pack_params(params, cfg.model)
    rep = np.repeat
    ga = np.pad(g_rgb, ((0, 0), (0, 125)))
    gb = np.pad(g_sig[:, None], ((0, 0), (0, 127)))
    _, _, dcond_rows, _ = jpal._fused_bwd_eval(
        tuple(arrs), jnp.asarray(pts),
        jnp.asarray(rep(dp.float().numpy(), S, 0)).astype(jnp.bfloat16),
        jnp.asarray(ga), jnp.asarray(gb), plan, cfg.model.posenc_xyz,
        interpret=True,
        condpart_flat=jnp.asarray(rep(cp.float().numpy(), S, 0)).astype(
            jnp.bfloat16))
    want = np.asarray(dcond_rows).reshape(R, S, -1).sum(1)
    got = out[4].numpy()
    assert _rms(got - want) <= 1e-3 * _rms(want), _rms(got - want) / _rms(
        want)


def test_pack_params_keeps_the_cond_rows_graph():
    """Packed with grad enabled, cond_kernel leads back to trunk_0's and
    the skip layer's cond rows (each entry once, the rest untouched), so a
    loss through the hoist reaches them; without grad it carries none."""
    cfg = load_config("blender_lego", SMALL)
    cc, cx = 16, 3 * (2 * 4 + 1)
    model = load_flax_params(jax.device_get(j_init(
        jax.random.PRNGKey(4), cfg.model, cc)), "bfloat16", cond_dim=cc)
    with torch.no_grad():
        assert not posenc_mlp.pack_params(model, False).cond_kernel \
            .requires_grad
    with torch.enable_grad():
        net = posenc_mlp.pack_params(model, hoist_x=False)
        assert net.cond_kernel.requires_grad
        net.cond_kernel.sum().backward()
    for layer in (model.trunk[0], model.trunk[2]):
        g = layer.weight.grad.t()
        assert bool((g[cx:cx + cc] == 1.0).all())
        assert not bool(g[:cx].any()) and not bool(g[cx + cc:].any())
    assert model.trunk[1].weight.grad is None
