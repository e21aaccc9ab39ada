"""The training step and loop; counterpart of `fashion_nerf.train.loop`.

A step gathers a ray batch from the device-resident rays, renders it
through the coarse and fine fields, takes the coarse + fine MSE (plus the
sparsity prior), backprops and applies Adam. With the fused field
(`kernels.use_pallas` and `kernels.fused_mlp`, and `kernels.fused_backward`
in training) the fields run K3 forward and K4 backward on CUDA tensors and
their plain versions on CPU tensors; otherwise the plain-torch NeRFMLP
field runs under autograd. The occupancy-accelerated step renders a
reduced budget inside each ray's box interval; every `occ_dense_every`-th
step stays dense. Evaluation renders the held-out view through K3 and K5.

Conditioned and latent fields (the try-on presets) train with a per-ray
cond built inside the step (`make_cond`: the garment encoder's code of the
run's garment stack, broadcast to every ray, then each ray's frame latent),
so the encoder and the latent table are part of the step's graph; K4 (or
its plain version) returns the condpart's cotangent. The occupancy refresh
and the evaluation take the per-scene cond vector (`_eval_cond`).

Under a ("dp", "tp") mesh (`dist.mesh`; the ranks started by
`python -m torch.distributed.run`) the step is the single-process step
split over rays: each rank renders its rows of the global batch, with its
rows of every per-ray draw (`prng.RowDraws`), the loss is its local mean
times its rows' share of the global batch (one rank: the single-process
loss bit for bit), terms not taken over rays (the sparsity prior)
count on the first dp block only, and the gradients are summed over the
ranks before Adam. Under tp > 1 Adam updates each rank's column shards and
the full weights are gathered for the next step (`dist.mesh.ShardedAdam`).
Every rank runs K3, K4 (and K5 in `evaluate`) on its own rows. With
`data.stream` the batches come from the host (`host_batch_iter`, through
`prefetch_to_device`) instead of the device-resident gather.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from fashion_nerf_torch.config import Config
from fashion_nerf_torch import ckpt as ckpt_lib
from fashion_nerf_torch.core.occupancy import build_from_config
from fashion_nerf_torch.data.pipeline import (RayDataset, host_batch_iter,
                                              prefetch_to_device, ray_dataset,
                                              sample_batch)
from fashion_nerf_torch.dist import mesh as dmesh
from fashion_nerf_torch.kernels import resolve_device
from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
from fashion_nerf_torch.logging_ import MetricLogger
from fashion_nerf_torch.metrics import mse_to_psnr, psnr
from fashion_nerf_torch.prng import GeneratorChain, RowDraws
from fashion_nerf_torch.render.renderer import render_image, render_rays
from fashion_nerf_torch.train.state import (TrainState, create_train_state,
                                            learning_rate)
from fashion_nerf_torch.trace import span


def _xla_field(net, pts, viewdirs, cond=None):
    return net.field(pts, viewdirs, cond)


def make_fields(cfg: Config, training: bool = False, plain: bool = False):
    """(field_coarse, field_fine), each field(net, pts (R,S,3), viewdirs
    (R,3), cond (R,Cc)=None) → (rgb, σ): the fused field when the config
    selects it, else
    the NeRFMLP's plain-torch field. plain=True makes the fused field take
    its plain versions on any device."""
    k = cfg.kernels
    if k.use_pallas and k.fused_mlp and (not training or k.fused_backward):
        field = make_fused_field(cfg, plain=plain)
        return field, field
    return _xla_field, _xla_field


def _bind(field, net, viewdirs):
    """A renderer field (pts, rays_d[, cond]) → (rgb, σ) with net and view
    directions captured (NDC rays_d are not view directions)."""
    return lambda pts, _rays_d, *cond: field(net, pts, viewdirs, *cond)


def sparsity_points(cfg: Config, generator, device):
    """(n, 1, 3) points uniform in the occupancy scan box."""
    o = cfg.occupancy
    u = torch.rand((cfg.train.sparsity_points, 1, 3), generator=generator,
                   device=device)
    return o.world_min + (o.world_max - o.world_min) * u


def sparsity_loss(cfg: Config, nets: dict, field_c, field_f, pts,
                  cond=None):
    """Cauchy density prior mean(log(1 + σ²/2)) at pts, summed over the
    coarse and the fine net. A conditioned field takes the first ray's
    cond (R, Cc) at every prior point, as the reference does (for a
    dynamic run: one frame's latent a step)."""
    n = pts.shape[0]
    dirs = torch.tensor([0.0, 0.0, -1.0], device=pts.device).expand(n, 3)
    extra = () if cond is None else (cond[:1].expand(n, cond.shape[-1]),)
    act = (torch.nn.functional.softplus
           if cfg.model.sigma_activation == "softplus" else torch.relu)
    total = 0.0
    for name, field in (("coarse", field_c), ("fine", field_f)):
        if nets.get(name) is None:
            continue
        _, sigma = field(nets[name], pts, dirs, *extra)
        total = total + torch.mean(torch.log1p(0.5 * act(sigma) ** 2))
    return total


def make_cond(cfg: Config, nets: dict, batch: dict, garment=None):
    """The per-ray cond (R, Cc) of a batch: the garment encoder's code of
    `garment` broadcast to every ray, then each ray's frame latent (frame
    ids clipped to the table), those the config has; None when it has
    neither. Built inside the step, so gradients reach the encoder and the
    latent table."""
    from fashion_nerf_torch.models.conditioned import encode_garment
    n_rays = batch["rays_o"].shape[0]
    parts = []
    if cfg.model.conditioned and "encoder" in nets and garment is not None:
        code = encode_garment(nets["encoder"], garment)
        parts.append(code.expand(n_rays, code.shape[-1]))
    if cfg.model.n_latents > 0 and "latents" in nets:
        ids = batch["frame_ids"].clamp(0, cfg.model.n_latents - 1)
        parts.append(nets["latents"](ids))
    return torch.cat(parts, dim=-1) if parts else None


class TrainStep:
    """One training step: step(state, all_rays, occ=None, sparsity_pts=None)
    → (state, metrics), updating state in place.

    streamed: all_rays is the batch itself (pre-gathered), as the
    reference's streamed step takes it; under a mesh, this rank's rows of
    it. occ_culled: the reduced occ_coarse + occ_fine budget inside the box
    of `occ`. sparsity_pts: explicit sparsity-prior points in place of the
    generator's draw. garment: the (H, W, 7) conditioning stack of a
    conditioned run. mesh: the ("dp", "tp") DeviceMesh of a distributed
    run (`dist.mesh`); its metrics are the global batch's on every rank."""

    def __init__(self, cfg: Config, dataset: RayDataset,
                 streamed: bool = False, occ_culled: bool = False,
                 plain: bool = False, garment=None, mesh=None):
        if occ_culled:
            cfg = dataclasses.replace(cfg, sampling=dataclasses.replace(
                cfg.sampling, n_coarse=cfg.train.occ_coarse,
                n_fine=(cfg.train.occ_fine if cfg.sampling.n_fine > 0
                        else 0)))
        self.cfg = cfg
        self.field_c, self.field_f = make_fields(cfg, training=True,
                                                 plain=plain)
        self.use_fine = cfg.sampling.n_fine > 0
        self.n_total = dataset.n_rays
        self.crop_idx = (dataset.crop_idx if cfg.train.precrop_iters > 0
                         else None)
        self.streamed = streamed
        self.garment = garment
        self.mesh = mesh
        self.rows = (None if mesh is None
                     else dmesh.ray_sharding(mesh, cfg.train.batch_rays))

    def draws(self, state: TrainState):
        """The step's per-ray draws: the state's generator, or this rank's
        rows of its draws at the global batch's shape."""
        if self.rows is None:
            return state.generator
        return RowDraws(state.generator, self.rows.start, self.rows.stop,
                        self.cfg.train.batch_rays)

    def _mse(self, rgb, target):
        """The batch's mean squared error; under a mesh this rank's share
        of it, its rows' mean times their share of the global batch, so
        that a group of one rank takes the single-process step bit for
        bit."""
        mse = torch.mean((rgb - target) ** 2)
        if self.mesh is None:
            return mse
        return mse * ((self.rows.stop - self.rows.start)
                      / self.cfg.train.batch_rays)

    def loss(self, state: TrainState, batch: dict, occ=None,
             sparsity_pts=None):
        """→ (loss, aux) with the autograd graph of the step; under a mesh
        this rank's share of them."""
        cfg, g = self.cfg, state.generator
        vd = batch["viewdirs"]
        cond = make_cond(cfg, state.nets(), batch, self.garment)
        fc = _bind(self.field_c, state.coarse, vd)
        ff = (_bind(self.field_f, state.fine, vd) if self.use_fine
              else None)
        out = render_rays(fc, ff, batch["rays_o"], batch["rays_d"], cfg,
                          train=True, generator=self.draws(state), occ=occ,
                          cond=cond)
        loss_c = self._mse(out["coarse"]["rgb"], batch["rgb"])
        loss, loss_f = loss_c, loss_c
        if self.use_fine:
            loss_f = self._mse(out["fine"]["rgb"], batch["rgb"])
            loss = loss_c + loss_f
        aux = {"mse_coarse": loss_c, "mse_fine": loss_f}
        if cfg.train.sparsity_weight > 0.0:
            pts = (sparsity_points(cfg, g, batch["rays_o"].device)
                   if sparsity_pts is None else sparsity_pts)
            if dmesh.axis_rank(self.mesh, "dp") == 0:
                # the prior is no sum over rays: the first dp block (whose
                # first ray is the batch's, the conditioned prior's cond)
                # counts it
                loss_sp = sparsity_loss(cfg, state.nets(), self.field_c,
                                        self.field_f, pts, cond)
            else:
                loss_sp = torch.zeros((), device=pts.device)
            loss = loss + cfg.train.sparsity_weight * loss_sp
            aux["sparsity"] = loss_sp
        return loss, aux

    def __call__(self, state: TrainState, all_rays: dict, occ=None,
                 sparsity_pts=None):
        with span("fnt.step"):
            cfg = self.cfg
            n = cfg.train.batch_rays if self.rows is None else (
                self.rows.stop - self.rows.start)
            with span("fnt.step.gather"):
                batch = all_rays if self.streamed else sample_batch(
                    all_rays, self.draws(state), n, self.n_total,
                    crop_idx=self.crop_idx, step=state.step,
                    precrop_iters=cfg.train.precrop_iters)
            with span("fnt.step.forward"):
                loss, aux = self.loss(state, batch, occ, sparsity_pts)
            opt = state.optimizer
            with span("fnt.step.backward"):
                opt.zero_grad(set_to_none=True)
                loss.backward()
            values = {"loss": loss.detach(),
                      **{k: v.detach() for k, v in aux.items()}}
            if self.mesh is not None:
                with span("fnt.step.reduce"):
                    dmesh.reduce_gradients(self.mesh, state.parameters())
                    values = dmesh.reduce_scalars(self.mesh, values)
            with span("fnt.step.adam"):
                for group in opt.param_groups:
                    group["lr"] = learning_rate(cfg, state.step)
                opt.step()
            state.step += 1
            metrics = {"loss": values["loss"],
                       "psnr": mse_to_psnr(values["mse_fine"]), **values}
            return state, metrics


def refresh_occupancy(cfg: Config, state: TrainState, plain: bool = False,
                      cond_vec=None):
    """The training-time culling grid from the live nets: σ is the max of
    the coarse and the fine field, so both nets' culled ranges are sound.
    cond_vec: the per-scene cond vector (Cc,) of a conditioned run, whose
    density the grid is swept with."""
    field_c, field_f = make_fields(cfg, plain=plain)
    dev = next(state.coarse.parameters()).device

    def union(pts, dirs, *cond):
        rgb, sigma = field_c(state.coarse, pts, dirs, *cond)
        if state.fine is not None and cfg.sampling.n_fine > 0:
            sigma = torch.maximum(sigma,
                                  field_f(state.fine, pts, dirs, *cond)[1])
        return rgb, sigma

    with torch.no_grad(), span("fnt.occ_refresh"):
        return build_from_config(cfg, union, device=dev, cond=cond_vec)


def evaluate(cfg: Config, state: TrainState, dataset: RayDataset,
             plain: bool = False, garment=None, frame_id: int = 0,
             mesh=None):
    """Render the held-out view (fused field; K5 compositing when
    kernels.fused_render) → (outputs, val PSNR). A conditioned or dynamic
    run renders with the cond vector of `garment` and frame `frame_id`'s
    latent (the held-out view has none of its own: frame 0 stands in).
    mesh: the view's chunks are dealt to the dp ranks (`render_image`)."""
    field_c, field_f = make_fields(cfg, plain=plain)
    fc = (lambda pts, vd, *c: field_c(state.coarse, pts, vd, *c))
    ff = None
    if cfg.sampling.n_fine > 0 and state.fine is not None:
        ff = (lambda pts, vd, *c: field_f(state.fine, pts, vd, *c))
    dev = dataset.rays_o.device
    with torch.no_grad():
        cond = _eval_cond(cfg, state.nets(), garment, frame_id)
        out = render_image(fc, ff, dataset.H, dataset.W, dataset.focal,
                           dataset.val_pose, cfg,
                           use_fused_render=(cfg.kernels.use_pallas
                                             and cfg.kernels.fused_render),
                           plain=plain, device=dev, cond=cond, mesh=mesh)
        val = torch.as_tensor(dataset.val_image, dtype=torch.float32,
                              device=dev)
        return out, float(psnr(out["rgb"], val))


def resolve_garment(cfg: Config, dataset_dict: dict, H: int, W: int,
                    device=None):
    """The garment conditioning stack (H, W, 7) of a run on `device`: the
    dataset's own, or, for a conditioned config on a dataset without one
    (the hermetic dynamic_tryon), the procedural pair's. None for an
    unconditioned config. Training, render and eval must agree on it."""
    if not cfg.model.conditioned:
        return None
    if "garment" in dataset_dict:
        return torch.as_tensor(dataset_dict["garment"], dtype=torch.float32,
                               device=device)
    from fashion_nerf_torch.data.viton import synth_viton_pair
    from fashion_nerf_torch.tryon.pipeline import build_conditioning
    return build_conditioning(synth_viton_pair(H, W), H, W, cfg=cfg,
                              device=device)


def _eval_cond(cfg: Config, nets: dict, garment, frame_id: int = 0):
    """The per-scene cond vector (Cc,) for whole-image renders: `make_cond`
    of one ray of frame `frame_id`; None when the config has neither a
    garment code nor latents."""
    ids = torch.tensor([frame_id], device=(
        nets["latents"].codes.weight.device if "latents" in nets else None))
    cond = make_cond(cfg, nets, {"rays_o": ids[:, None], "frame_ids": ids},
                     garment)
    return None if cond is None else cond[0]


def train(cfg: Config, dataset_dict: Optional[dict] = None,
          log_fn: Optional[Callable] = None, resume: bool = False,
          fault_at_step: Optional[int] = None, device=None, mesh=None):
    """The training loop: data → state → steps with the log, eval and
    checkpoint cadences → (state, history).

    resume: restore the latest checkpoint under out_dir/name/ckpt and
    continue the identical trajectory. fault_at_step: raise at that step
    (a test hook for kill-and-resume). Log entries carry the cumulative
    counts of occupancy refreshes, culled and dense steps. device: CUDA
    by default; the CPU (every kernel's plain version) only when asked for
    by name; raises when CUDA is wanted and there is none.

    Distribution: joins the launcher's process group
    (`dist.mesh.init_distributed(cfg.dist.multihost)`) and, without a
    `mesh`, takes cfg.dist's (`resolve_mesh`: None in one process). Every
    rank holds the same state and history; rank 0 alone logs and writes
    checkpoints. data.stream: the batches come from `host_batch_iter`
    through `prefetch_to_device`, this rank's rows of each."""
    dmesh.init_distributed(cfg.dist.multihost, device=device)
    device = resolve_device(device)      # after the join: a rank's card
    if mesh is None:
        mesh = dmesh.resolve_mesh(cfg.dist)
    if dataset_dict is None:
        dataset_dict = load_dataset(cfg, device)
    dataset = ray_dataset(cfg, dataset_dict["images"], dataset_dict["poses"],
                          dataset_dict["focal"], device=device)
    dataset.val_image = dataset_dict["val_image"]
    dataset.val_pose = dataset_dict["val_pose"]

    chain = GeneratorChain(cfg.train.seed)
    state = create_train_state(cfg, chain.once("init"),
                               chain.once("run", device), device)
    chain.freeze()     # every later draw comes from state.generator
    if mesh is not None:
        state = dmesh.shard_state(mesh, state)
    garment = resolve_garment(cfg, dataset_dict, dataset.H, dataset.W,
                              device)
    streamed = cfg.data.stream
    step_fn = TrainStep(cfg, dataset, streamed=streamed, garment=garment,
                        mesh=mesh)
    occ_train = cfg.train.occ_train
    step_fast = (TrainStep(cfg, dataset, streamed=streamed, occ_culled=True,
                           garment=garment, mesh=mesh)
                 if occ_train else None)
    all_rays = dataset.batch_arrays()
    batch_iter = None
    if streamed:
        batch_iter = prefetch_to_device(
            host_batch_iter(all_rays, cfg.train.batch_rays,
                            seed=cfg.train.seed),
            size=2, device=device, rows=step_fn.rows)
    main = dmesh.is_main()
    logger = log_fn or MetricLogger(cfg if main else None)
    log = logger if main else (lambda entry: None)
    ckpt_dir = os.path.join(cfg.out_dir, cfg.name, "ckpt")
    start = 0
    if resume and ckpt_lib.latest_step(ckpt_dir) is not None:
        state = ckpt_lib.restore(ckpt_dir, state)
        start = state.step
    history = []
    counts = {"refreshes": 0, "culled_steps": 0, "dense_steps": 0}
    occ_state, last_val_psnr = None, None
    t0, rays_done = time.perf_counter(), 0
    for i in range(start, int(cfg.train.iters)):
        if fault_at_step is not None and i == fault_at_step:
            raise RuntimeError(f"injected fault at step {i}")
        if occ_train and i >= cfg.train.occ_warmup and (
                occ_state is None or i % cfg.train.occ_refresh_every == 0):
            with torch.no_grad():
                cond_vec = _eval_cond(cfg, state.nets(), garment)
            occ_state = refresh_occupancy(cfg, state, cond_vec=cond_vec)
            if mesh is not None:
                # every rank sweeps; rank 0's grid is the one all cull with
                dmesh.broadcast_(occ_state)
            counts["refreshes"] += 1
        batch = next(batch_iter) if streamed else all_rays
        if (occ_state is not None
                and (i + 1) % cfg.train.occ_dense_every != 0):
            state, metrics = step_fast(state, batch, occ_state)
            counts["culled_steps"] += 1
        else:
            state, metrics = step_fn(state, batch)
            counts["dense_steps"] += 1
        rays_done += cfg.train.batch_rays
        if (i + 1) % cfg.train.log_every == 0:
            entry = {k: float(v) for k, v in metrics.items()}  # syncs
            now = time.perf_counter()
            entry.update(step=i + 1, rays_per_sec=rays_done / (now - t0),
                         **counts)
            t0, rays_done = now, 0
            history.append(entry)
            log(entry)
        if (i + 1) % cfg.train.eval_every == 0:
            _, last_val_psnr = evaluate(cfg, state, dataset,
                                        garment=garment, mesh=mesh)
            log({"step": i + 1, "val_psnr": last_val_psnr})
            history.append({"step": i + 1, "val_psnr": last_val_psnr})
            t0 = time.perf_counter()   # eval stays out of the rays/s window
        if (i + 1) % cfg.train.ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, state, keep=cfg.train.ckpt_keep,
                          metrics=({"val_psnr": last_val_psnr}
                                   if last_val_psnr is not None else None))
            t0 = time.perf_counter()
    return state, history


def load_dataset(cfg: Config, device=None) -> dict:
    """The dataset of cfg.data: the hermetic procedural scenes when no
    data.root is given (the blender one at the framing the committed
    flagship weights were trained on), else the scene under data.root
    (the tiny npz layout, a NeRF-synthetic scene, an LLFF scene); for
    viton, the scene with its garment conditioning stack built on
    `device`."""
    from fashion_nerf_torch.data import synthetic
    from fashion_nerf_torch.data.tiny import load_tiny
    d = cfg.data
    if d.dataset == "tiny":
        return load_tiny(d.root)
    if d.dataset == "viton":
        from fashion_nerf_torch.data.viton import load_viton_scene
        return load_viton_scene(d.root, cfg=cfg, device=device)
    if d.dataset == "blender" and not d.root:
        scene = synthetic.make_synthetic_scene(
            n_views=16, H=160, W=160, scale=0.5, sharp=80.0, texture=0.6)
        scene.update(H=160, W=160, near=2.0, far=6.0)
        return scene
    if d.dataset == "llff" and not d.root:
        return synthetic.make_forward_scene(n_views=12, H=96, W=128)
    if d.dataset == "blender":
        from fashion_nerf_torch.data.blender import load_blender
        return load_blender(d.root, half_res=d.half_res,
                            white_bkgd=cfg.render.white_bkgd)
    if d.dataset == "llff":
        from fashion_nerf_torch.data.llff import load_llff
        return load_llff(d.root, factor=d.llff_factor,
                         spherify=d.llff_spherify)
    raise ValueError(f"unknown dataset {d.dataset!r}")
