"""The proposal distillation of the port against the reference's, on the
CPU (models/proposal.py), for the spec sweep's 3×256 L = 8 proposal (the
row "proposal p64+f64+cov16 w256d3", scripts/quality_check.py:448-455).

The port's seed-7 initial weights (`distill_start`, the seed
`attach_proposal` distils from) are carried into the reference, and both
packages' Adam steps run on the same points, each with its own teacher
(the committed fine weights: the port's fused field in its plain version,
the reference's XLA field). The reference's loop body is rebuilt here from
its own functions (`make_field`, its loss, `optax.adam` with
`cosine_decay_schedule`), since its `distill_proposal` draws its points
itself.

- At a small batch the two steps agree after each of the first steps.
- On the points the port draws for seed 7 at the row's batch of 8192, the
  reference's step dies too: σ ≤ 0 on every box point within a few steps,
  after which relu passes no gradient. So the row's death on the card is
  down to this init and these points, not to the port's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashion_nerf.config import load_config as ref_load_config
from fashion_nerf.models.nerf_mlp import make_field as ref_make_field
from fashion_nerf.models.proposal import \
    proposal_model_config as ref_proposal_model_config
from fashion_nerf_torch.assets import load_flagship
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.kernels.posenc_mlp import field_for
from fashion_nerf_torch.models import proposal as P
from fashion_nerf_torch.models.nerf_mlp import load_flax_params

# the distillation's overrides of the sweep row; the render's do not enter
ROW = ("kernels.use_pallas=true", "occupancy.enabled=true",
       "occupancy.macro=8", "proposal.net_width=256", "proposal.net_depth=3",
       "proposal.posenc_xyz=8", "proposal.distill_steps=1500")
# the occupancy box of the committed fine weights under the row's config
# (build_from_config and the reference's build_jit give the same)
BOX = ((-0.8125, -0.6875, -0.8125), (0.875, 0.8125, 0.75))
WORLD = (-1.5, 1.5)


@pytest.fixture(scope="module")
def setup():
    cfg = load_config("blender_lego", list(ROW))
    rcfg = ref_load_config("blender_lego", list(ROW))
    trained, _ = load_flagship()
    fine = load_flax_params(trained["fine"], compute_dtype="bfloat16")
    teacher_field = field_for(cfg)
    student_field = field_for(cfg, training=True)
    _, ref_teacher = ref_make_field(rcfg.model)
    _, ref_student = ref_make_field(ref_proposal_model_config(rcfg))
    return dict(cfg=cfg, rcfg=rcfg, fine=fine, ref_fine=trained["fine"],
                teacher=teacher_field, student=student_field,
                ref_teacher=jax.jit(ref_teacher), ref_student=ref_student)


class RefRun:
    """The reference's distillation loop body (models/proposal.py:94-118)
    on points handed to it."""

    def __init__(self, s, params, batch):
        rcfg = s["rcfg"]
        steps = rcfg.proposal.distill_steps
        self.tx = optax.adam(optax.cosine_decay_schedule(
            rcfg.proposal.distill_lr, steps))
        self.params = jax.tree_util.tree_map(jnp.asarray, params)
        self.opt = self.tx.init(self.params)
        dirs = jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0], jnp.float32),
                                (batch, 3))
        field, teacher, fine = s["ref_student"], s["ref_teacher"], \
            jax.tree_util.tree_map(jnp.asarray, s["ref_fine"])

        def loss_fn(p, pts, y):
            _, s_raw = field(p, pts, dirs, None)
            return jnp.mean((jnp.log1p(jax.nn.relu(s_raw[:, 0])) - y) ** 2)

        @jax.jit
        def step(p, opt, pts):
            _, s_t = teacher(fine, pts, dirs, None)
            y = jax.lax.stop_gradient(jnp.log1p(jax.nn.relu(s_t[:, 0])))
            loss, grads = jax.value_and_grad(loss_fn)(p, pts, y)
            updates, opt = self.tx.update(grads, opt, p)
            return optax.apply_updates(p, updates), opt, loss, grads

        self._step = step
        self.sigma = jax.jit(lambda p, pts: field(
            p, pts, jnp.broadcast_to(dirs[:1], (pts.shape[0], 3)),
            None)[1][:, 0])

    def step(self, pts, with_grads=False):
        self.params, self.opt, loss, grads = self._step(
            self.params, self.opt, jnp.asarray(pts))
        return (float(loss), grads) if with_grads else float(loss)


class PortRun:
    """The port's loop body: its teacher's targets, then `Distiller.step`."""

    def __init__(self, s, student):
        self.s = s
        self.run = P.Distiller(s["cfg"], student,
                               s["cfg"].proposal.distill_steps, s["student"])

    def step(self, i, pts):
        pts = torch.as_tensor(pts)
        dirs = torch.tensor([0.0, 0.0, -1.0]).expand(pts.shape[0], 3)
        with torch.no_grad():
            y = P.log_density(self.s["teacher"](self.s["fine"], pts,
                                                dirs)[1][:, 0])
        return float(self.run.step(i, pts, y).detach())

    def sigma(self, pts):
        pts = torch.as_tensor(pts)
        dirs = torch.tensor([0.0, 0.0, -1.0]).expand(pts.shape[0], 3)
        with torch.no_grad():
            return self.s["student"](self.run.student, pts, dirs)[1][:, 0]


def _flat(tree) -> np.ndarray:
    p = tree["params"]
    return np.concatenate([np.asarray(p[k][n], np.float64).ravel()
                           for k in sorted(p) for n in ("kernel", "bias")])


def _box_points(rng, n):
    lo, hi = (np.asarray(b, np.float32) for b in BOX)
    return (lo + rng.random((n, 1, 3), dtype=np.float32) * (hi - lo))


def _numpy_points(rng, batch):
    """The reference's draw: 7/8 in the box, the rest across the world."""
    u = rng.random((batch, 1, 3), dtype=np.float32)
    sel = rng.random((batch, 1, 1), dtype=np.float32) < 0.875
    lo, hi = (np.asarray(b, np.float32) for b in BOX)
    return np.where(sel, lo + u * (hi - lo),
                    WORLD[0] + u * (WORLD[1] - WORLD[0])).astype(np.float32)


def _named(student):
    """(reference layer name, "kernel"/"bias", torch parameter)."""
    return [(name, kind, layer.weight if kind == "kernel" else layer.bias)
            for name, layer in student.named_dense()
            for kind in ("kernel", "bias")]


def _put(student, opt, params, mu, nu, count):
    """Load the reference's parameters and Adam moments into the port's
    student and optimizer (kernels (in, out) → weights (out, in))."""
    with torch.no_grad():
        for name, kind, prm in _named(student):
            for dst, src in ((prm, params), ):
                v = np.asarray(src["params"][name][kind])
                dst.copy_(torch.as_tensor(v.T if kind == "kernel" else v))
            st = opt.state[prm]
            for key, src in (("exp_avg", mu), ("exp_avg_sq", nu)):
                v = np.asarray(src["params"][name][kind])
                st[key].copy_(torch.as_tensor(v.T if kind == "kernel" else v))
            st["step"].fill_(int(count))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_steps_match_reference(setup):
    """The first 6 Adam steps from the port's seed-7 init on numpy batches
    of 1024 points, each step taken by both packages from the same state
    (the reference's parameters and moments loaded into the port before
    each step). After each step: loss within 2e-3 relative; Adam's first
    and second moments of every parameter within 3e-2 relative RMS (the
    step-0 gradients within 1e-2); the step's parameter moves within 1e-1
    relative RMS of each other; the share of check points with σ > 0
    within 0.01. The bounds are bf16's: both students run their matmuls in
    bf16 with f32 sums in another order (the step-0 gradients differ by
    0.4–0.8%, the rounding of bf16), and Adam moves every weight by about
    ±lr at step 0 whatever its gradient's size, so a weight whose gradient
    is near 0 may move the other way in the other package (6% of the
    step's moves at step 0). On these points σ > 0 falls to under 1% of
    the check points by step 5 in both packages."""
    cfg = setup["cfg"]
    student, _ = P.distill_start(cfg,
                                 torch.Generator().manual_seed(P.DISTILL_SEED))
    ref = RefRun(setup, student.to_flax_params(), 1024)
    port = PortRun(setup, student)
    rng = np.random.default_rng(5)
    check = _box_points(rng, 4096)
    shares = []
    for i in range(6):
        pts = _numpy_points(rng, 1024)
        if i > 0:
            adam = jax.device_get(ref.opt[0])
            _put(student, port.run.opt, jax.device_get(ref.params),
                 adam.mu, adam.nu, adam.count)
        before = _flat(jax.device_get(ref.params))
        lp = port.step(i, pts)
        lr, grads = ref.step(pts, with_grads=True)
        assert abs(lp - lr) <= 2e-3 * lr, (i, lp, lr)
        adam = jax.device_get(ref.opt[0])
        for name, kind, prm in _named(student):
            def ref_of(tree):
                v = np.asarray(tree["params"][name][kind], np.float64)
                return v.T if kind == "kernel" else v
            st = port.run.opt.state[prm]
            for what, got, want, tol in (
                    ("mu", st["exp_avg"], adam.mu, 3e-2),
                    ("nu", st["exp_avg_sq"], adam.nu, 3e-2),
                    ("grad", prm.grad, jax.device_get(grads),
                     1e-2 if i == 0 else np.inf)):
                r = _rel(got.double().numpy(), ref_of(want))
                assert r <= tol, (i, name, kind, what, r)
        moved_p = _flat(student.to_flax_params()) - before
        moved_r = _flat(jax.device_get(ref.params)) - before
        assert _rel(moved_p, moved_r) <= 1e-1, (i, _rel(moved_p, moved_r))
        share_p = float((port.sigma(check) > 0).float().mean())
        share_r = float((np.asarray(ref.sigma(ref.params, check)) > 0).mean())
        assert abs(share_p - share_r) <= 0.01, (i, share_p, share_r)
        shares.append(share_r)
    assert shares[0] > 0.5 and shares[-1] < 0.01, shares


def test_reference_dies_on_the_ports_points(setup):
    """Seed 7 at the row's batch of 8192: the points the port draws
    (`distill_start`'s generator, on the CPU) kill the student in the
    reference's step as in the port's. The init has σ > 0 on 31% of the
    check points of the box; after 8 steps both students have σ > 0 on
    none, and their losses agree within 1e-2 relative at every step."""
    cfg = setup["cfg"]
    batch = cfg.proposal.distill_batch
    student, g_data = P.distill_start(
        cfg, torch.Generator().manual_seed(P.DISTILL_SEED))
    ref = RefRun(setup, student.to_flax_params(), batch)
    port = PortRun(setup, student)
    check = _box_points(np.random.default_rng(6), 4096)
    assert float((port.sigma(check) > 0).float().mean()) > 0.25
    wmin = torch.full((3,), WORLD[0])
    wmax = torch.full((3,), WORLD[1])
    bmin, bmax = (torch.tensor(b) for b in BOX)
    for i in range(8):
        pts = P.distill_points(g_data, batch, bmin, bmax, wmin, wmax).numpy()
        lp, lr = port.step(i, pts), ref.step(pts)
        assert abs(lp - lr) <= 1e-2 * lr, (i, lp, lr)
    assert not bool((port.sigma(check) > 0).any())
    assert not bool((np.asarray(ref.sigma(ref.params, check)) > 0).any())
