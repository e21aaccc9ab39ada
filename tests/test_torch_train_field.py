"""The fused field's gradient path on the CPU: `FusedField` (K3 forward,
K4 backward, here their plain versions) against the reference's fused VJP
(`make_fused_field` → `_pallas_backward`, Pallas in interpret mode), by
reference layer name. Each gradient must also sit in the reference's
envelope around f32 truth: RMS error ≤ 2.5× the bf16 XLA field's,
+1e-4·scale (tests/kernels/test_posenc_mlp.py:283-288)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf.kernels.posenc_mlp_pallas import make_fused_field as j_mff
from fashion_nerf.models.nerf_mlp import init_field as j_init
from fashion_nerf.models.nerf_mlp import make_field
from fashion_nerf_torch.kernels import posenc_mlp
from fashion_nerf_torch.models.nerf_mlp import init_field, load_flax_params

torch.set_num_threads(2)

SMALL = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4"]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _loss_j(field):
    def f(p, x, d):
        rgb, sig = field(p, x, d, None)
        return jnp.mean(rgb ** 2) + 0.01 * jnp.mean(jax.nn.relu(sig) ** 2)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


def test_loss_through_fused_field_reaches_every_parameter():
    """A loss through make_fused_field gives every NeRFMLP parameter a
    nonzero gradient (the field used to pack its weights under no_grad,
    which cut them off from autograd)."""
    cfg = load_config("blender_lego", SMALL + ["model.skips=1"])
    model = init_field(cfg.model, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    pts = torch.tensor(rng.uniform(-1, 1, (8, 16, 3)), dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(8, 3)), dtype=torch.float32)
    rgb, sigma = posenc_mlp.make_fused_field()(model, pts, dirs)
    (torch.mean((rgb - 0.5) ** 2) + torch.mean(torch.relu(sigma))).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert float(p.grad.abs().sum()) > 0.0, name


@pytest.mark.parametrize("overrides,R,S", [
    (SMALL, 16, 8),
    (SMALL + ["model.use_viewdirs=false"], 16, 8),
    ([], 2, 64),                                  # full width, 128 rows
], ids=["small", "small_no_viewdirs", "full_width"])
def test_fused_field_gradients_match_reference(overrides, R, S):
    cfg = load_config("blender_lego", ["kernels.interpret=true"] + overrides)
    params = j_init(jax.random.PRNGKey(0), cfg.model)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    args = (params, jnp.asarray(pts), jnp.asarray(dirs))
    g_pal = _loss_j(j_mff(cfg))(*args)
    g_bf = _loss_j(make_field(cfg.model)[1])(*args)
    f32 = load_config("blender_lego",
                      overrides + ["model.compute_dtype=float32"])
    with jax.default_matmul_precision("highest"):
        g_f32 = _loss_j(make_field(f32.model)[1])(*args)

    model = load_flax_params(jax.device_get(params),
                             compute_dtype="bfloat16")
    x = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    rgb, sig = posenc_mlp.make_fused_field()(model, x, d)
    (torch.mean(rgb ** 2) + 0.01 * torch.mean(torch.relu(sig) ** 2)
     ).backward()

    got = {(n, "kernel"): layer.weight.grad.numpy().T
           for n, layer in model.named_dense()}
    got.update({(n, "bias"): layer.bias.grad.numpy()
                for n, layer in model.named_dense()})
    cases = [(key, g, *(np.asarray(t[0]["params"][key[0]][key[1]])
                        for t in (g_pal, g_bf, g_f32)))
             for key, g in got.items()]
    cases.append((("pts",), x.grad.numpy(),
                  *(np.asarray(t[1]) for t in (g_pal, g_bf, g_f32))))
    if cfg.model.use_viewdirs:
        cases.append((("viewdirs",), d.grad.numpy(),
                      *(np.asarray(t[2]) for t in (g_pal, g_bf, g_f32))))
    for key, g, p, b, c in cases:
        scale = _rms(c) + 1e-12
        assert _rms(g - c) <= 2.5 * _rms(b - c) + 1e-6 + 1e-4 * scale, key
        # the reference's rounding points: only the f32 summation order
        # differs, which at width 256 flips a few bf16 roundings
        # (measured 3.9e-4 relative on trunk_0's kernel)
        assert _rms(g - p) <= 2e-3 * (_rms(p) + 1e-12), key
