"""σ-only proposal field; counterpart of `fashion_nerf.models.proposal`.

A 2×128 σ-only MLP (posenc L=6) shapes the fine-pass PDF at render time in
place of the full coarse network. `attach_proposal` takes it from the
committed asset (assets/proposal_synthetic.npz) when the asset's sha256
teacher signature matches the fine weights, and otherwise distils a new one
from the fine field (`distill_proposal`): Adam steps that match
log(1 + σ) at random points, 7/8 of them inside the occupancy box and 1/8
across the whole scan box so that σ outside stays pinned at the teacher's.
`distill_proposal` runs the student as a plain module under autograd, as
the reference does outside its kernels, unless it is handed another field;
`attach_proposal` runs the teacher through `posenc_mlp.field_for`'s field
for inference and the student through its field for training (the fused
field, K3 with K4 as its backward, where the config takes it). A
conditioned fine field teaches with the scene's cond vector; the student
stays unconditioned, and the asset's match, as the reference's, carries no
cond fingerprint: an asset signed for these fine weights is attached
whatever the cond.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from fashion_nerf_torch.assets import (ASSETS_DIR, _flatten, load_params,
                                       save_params)
from fashion_nerf_torch.config import Config, ModelConfig
from fashion_nerf_torch.kernels.posenc_mlp import field_for
from fashion_nerf_torch.kernels.sigmamarch import _density
from fashion_nerf_torch.models.nerf_mlp import (NeRFMLP, cond_width,
                                                init_field, load_flax_params,
                                                module_field)

PROPOSAL_ASSET = os.path.join(ASSETS_DIR, "proposal_synthetic.npz")
DISTILL_SEED = 7              # the seed `attach_proposal` distils from


def proposal_model_config(cfg: Config) -> ModelConfig:
    """The proposal net as a ModelConfig: no view branch, no cond, no skip."""
    p = cfg.proposal
    return ModelConfig(
        net_depth=p.net_depth, net_width=p.net_width, skips=(),
        posenc_xyz=p.posenc_xyz, posenc_dir=4, use_viewdirs=False,
        sigma_activation=cfg.model.sigma_activation,
        compute_dtype=cfg.model.compute_dtype,
        conditioned=False, n_latents=0)


def init_proposal(cfg: Config, generator: torch.Generator,
                  device=None) -> NeRFMLP:
    """A freshly initialised proposal net, drawn from `generator`."""
    return init_field(proposal_model_config(cfg), generator, device)


def log_density(sigma_raw, sigma_activation: str = "relu"):
    """log(1 + act(σ)): what the distillation matches."""
    return torch.log1p(_density(sigma_raw, sigma_activation == "softplus"))


def distill_loss(student: NeRFMLP, pts, targets,
                 sigma_activation: str = "relu", field: Callable = None):
    """mean((log1p(act(σ_student(pts))) − targets)²) for pts (B, 1, 3) and
    targets (B,), the log-densities of the teacher at pts. field: an
    unbound field (net, pts, viewdirs) → (rgb, σ raw) to run the student
    through (default: the module's own plain field)."""
    dirs = torch.tensor([0.0, 0.0, -1.0], device=pts.device).expand(
        pts.shape[0], 3)
    _, s_raw = (field or module_field)(student, pts, dirs)
    return torch.mean((log_density(s_raw[:, 0], sigma_activation)
                       - targets) ** 2)


def distill_points(generator: torch.Generator, batch: int, bmin, bmax, wmin,
                   wmax):
    """(batch, 1, 3) points: each uniform in the box [bmin, bmax] with
    probability 7/8, else at the same relative position of [wmin, wmax]."""
    dev = bmin.device
    u = torch.rand((batch, 1, 3), generator=generator, device=dev)
    sel = torch.rand((batch, 1, 1), generator=generator, device=dev) < 0.875
    return torch.where(sel, bmin + u * (bmax - bmin), wmin + u * (wmax - wmin))


def distill_start(cfg: Config, generator: torch.Generator, device=None):
    """→ (the student's initial weights, the points' generator): one seed
    each, drawn from `generator`; the weights are drawn on the CPU, the
    points on `device`. What `distill_proposal` starts from."""
    device = torch.device(device or "cpu")
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                          device=generator.device).tolist()
    student = init_proposal(cfg, torch.Generator().manual_seed(seeds[0]),
                            device)
    return student, torch.Generator(device=device).manual_seed(seeds[1])


class Distiller:
    """The student and its Adam state over a distillation of `steps`
    steps: the reference's optax.adam (b1 0.9, b2 0.999, ε 1e-8, no ε
    under the root) with a cosine schedule from proposal.distill_lr to 0
    (optax's `cosine_decay_schedule`, read at the pre-update count).
    field: the unbound field the student runs through (`distill_loss`)."""

    def __init__(self, cfg: Config, student: NeRFMLP, steps: int,
                 field: Callable = None):
        self.student, self.steps, self.field = student, steps, field
        self.lr0 = cfg.proposal.distill_lr
        self.act = cfg.model.sigma_activation
        self.opt = torch.optim.Adam(student.parameters(), lr=self.lr0,
                                    betas=(0.9, 0.999), eps=1e-8)

    def step(self, i: int, pts, y):
        """Adam step i on points pts (B, 1, 3) and the teacher's
        log-densities y (B,) there → the loss before the step."""
        frac = min(i, self.steps) / self.steps
        for group in self.opt.param_groups:
            group["lr"] = self.lr0 * 0.5 * (1.0 + math.cos(math.pi * frac))
        with torch.enable_grad():
            loss = distill_loss(self.student, pts, y, self.act, self.field)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        self.opt.step()
        return loss


def distill_proposal(cfg: Config, teacher: Callable,
                     generator: torch.Generator, box_min=None, box_max=None,
                     steps: Optional[int] = None, device=None,
                     field: Callable = None) -> NeRFMLP:
    """Fit the proposal σ to a trained teacher field by log-density matching.

    teacher: bound field (pts (B,1,3), viewdirs (B,3)) → (rgb, σ raw), run
      under no_grad with the fixed view direction (0, 0, −1).
    generator: seeds every draw (the initial weights and the points,
      `distill_start`), so the result is a function of its state alone.
    box_min/box_max: (3,) sampling region of 7/8 of the points (the
      occupancy box when there is one); the rest sample occupancy.world.
    steps: in place of cfg.proposal.distill_steps.
    field: the unbound field the student runs through (`distill_loss`).

    Adam steps of `Distiller`. Returns the proposal net on `device`."""
    pcfg = cfg.proposal
    steps = int(pcfg.distill_steps if steps is None else steps)
    batch = int(pcfg.distill_batch)
    device = torch.device(device or "cpu")
    act = cfg.model.sigma_activation

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device
                               ).expand(3)

    wmin, wmax = vec(cfg.occupancy.world_min), vec(cfg.occupancy.world_max)
    bmin = wmin if box_min is None else vec(box_min)
    bmax = wmax if box_max is None else vec(box_max)
    dirs = torch.tensor([0.0, 0.0, -1.0], device=device).expand(batch, 3)
    student, g_data = distill_start(cfg, generator, device)
    run = Distiller(cfg, student, steps, field)
    t0 = time.perf_counter()
    loss = torch.zeros((), device=device)
    for i in range(steps):
        pts = distill_points(g_data, batch, bmin, bmax, wmin, wmax)
        with torch.no_grad():
            y = log_density(teacher(pts, dirs)[1][:, 0], act)
        loss = run.step(i, pts, y)
    final = float(loss.detach())    # the one host sync
    secs = time.perf_counter() - t0
    print(f"fashion-nerf-torch: proposal distilled in {steps} steps "
          f"({secs:.2f} s on {device.type}), final log-density MSE "
          f"{final:.4g}", file=sys.stderr)
    return student


def distill_health(cfg: Config, teacher: Callable, student: NeRFMLP,
                   box_min, box_max, n: int = 8192, seed: int = 0) -> dict:
    """The student against its teacher on n points uniform in the box
    (box_min, box_max), drawn from `seed` on the student's device:
    share (of points with σ > 0), mse (of the log-densities), teacher_ms
    (the teacher's own mean square: what a student with σ ≤ 0 everywhere
    scores), and dead: σ > 0 on no point, or mse within 1% of teacher_ms.
    teacher: bound field (pts, viewdirs) → (rgb, σ raw)."""
    dev = next(student.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.as_tensor(box_min, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(box_max, dtype=torch.float32, device=dev)
    pts = lo + torch.rand((n, 1, 3), generator=g, device=dev) * (hi - lo)
    dirs = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(n, 3)
    act = cfg.model.sigma_activation
    with torch.no_grad():
        y = log_density(teacher(pts, dirs)[1][:, 0], act)
        sigma = module_field(student, pts, dirs)[1][:, 0]
    share = float((sigma > 0).float().mean())
    mse = float(((log_density(sigma, act) - y) ** 2).mean())
    teacher_ms = float((y ** 2).mean())
    return {"share": share, "mse": mse, "teacher_ms": teacher_ms,
            "dead": share == 0.0 or mse >= 0.99 * teacher_ms}


def _teacher_signature(fine_params) -> str:
    """sha256 over every leaf's f32 bytes in path-sorted order (key path
    bytes first), exactly as the reference computes it. Takes the
    reference's parameter tree or a NeRFMLP."""
    if isinstance(fine_params, NeRFMLP):
        fine_params = fine_params.to_flax_params()
    flat = _flatten(fine_params)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(
            np.asarray(flat[k], dtype=np.float32)).tobytes())
    return h.hexdigest()


def _asset_meta(cfg: Config, fine_params) -> dict:
    return {"config": cfg.name,
            "teacher_sig": _teacher_signature(fine_params),
            "net_depth": cfg.proposal.net_depth,
            "net_width": cfg.proposal.net_width,
            "posenc": cfg.proposal.posenc_xyz}


def attach_proposal(cfg: Config, params: dict, occ=None, cond=None,
                    generator: Optional[torch.Generator] = None,
                    allow_distill: bool = True, use_asset: bool = True,
                    path: str = PROPOSAL_ASSET, device=None) -> dict:
    """Return a copy of `params` with "proposal" (a NeRFMLP) attached, in
    the reference's resolution order:

      1. the committed asset, when its meta matches this config and these
         fine weights (and `use_asset`);
      2. a proposal distilled here from params["fine"], when
         `allow_distill`;
      3. `params` unchanged: the blockwise renderer then takes the full
         coarse march.

    occ: an OccupancyState whose box tightens the distillation's points.
    cond: the per-scene cond vector (Cc,) a conditioned teacher is run
    with (the proposal is distilled for it; the asset match ignores it).
    generator: the distillation's draws (default: seed DISTILL_SEED)."""
    if not (cfg.proposal.enabled and cfg.sampling.n_fine > 0
            and "fine" in params):
        return params
    fine = params["fine"]
    if device is None and isinstance(fine, NeRFMLP):
        device = next(fine.parameters()).device
    if use_asset and os.path.exists(path):
        prop, meta = load_params(path)
        want = _asset_meta(cfg, fine)
        got = {k: (str(meta.get(k, "")) if isinstance(v, str)
                   else int(meta.get(k, -1))) for k, v in want.items()}
        if got == want:
            return {**params, "proposal": load_flax_params(
                prop, compute_dtype=cfg.model.compute_dtype, device=device)}
    if not allow_distill:
        return params
    if not isinstance(fine, NeRFMLP):
        fine = load_flax_params(fine, compute_dtype=cfg.model.compute_dtype,
                                device=device, cond_dim=cond_width(cfg.model))
    if generator is None:
        generator = torch.Generator().manual_seed(DISTILL_SEED)
    teacher_field = field_for(cfg)
    if cond is not None:
        cvec = torch.as_tensor(cond, dtype=torch.float32, device=device)

        def teacher(pts, dirs):
            return teacher_field(fine, pts, dirs,
                                 cvec.expand(pts.shape[0], cvec.shape[-1]))
    else:
        def teacher(pts, dirs):
            return teacher_field(fine, pts, dirs)
    prop = distill_proposal(
        cfg, teacher, generator,
        box_min=None if occ is None else occ.box_min,
        box_max=None if occ is None else occ.box_max, device=device,
        field=field_for(cfg, training=True))
    return {**params, "proposal": prop}


def save_proposal_asset(cfg: Config, proposal: NeRFMLP, fine_params,
                        path: Optional[str] = None) -> str:
    """Write a distilled proposal in the asset's format, signed for these
    fine weights, so that later runs skip the distillation."""
    path = path or PROPOSAL_ASSET
    save_params(path, proposal.to_flax_params(),
                meta=_asset_meta(cfg, fine_params))
    return path
