"""The general training generator: the train loop's steps, closed loop.

A traffic file with "driver": "train" gives:

- "scene": the training scene the benchmark makes (perfbench/scenes.py:
  {"kind": "spheres" | "forward", …});
- "overrides": {dotted key: value} applied to the configuration (the
  batch, `train.batch_rays`);
- "start_step": the step count the run begins at (past
  `train.occ_warmup`: the schedule of culled and dense steps and of
  occupancy refreshes is the train loop's from there on);
- "check_steps": the steps of set-up that the reference follows.

The program: the configuration's weights (committed, or seeded by the
benchmark) through the program's `state_from_params`, its `RayDataset`
of the benchmark's scene, one `TrainStep` dense and one culled and
`refresh_occupancy`, in the schedule of `train()`: a refresh when the
step count calls for it, every `occ_dense_every`-th step dense, the
others culled (all dense without `train.occ_train`). The run's seed seeds
the step's generator. Set-up runs the first `check_steps` steps through
those same objects (the warm-up of both kinds of step and of a refresh);
the window continues from there. A step ends with
`torch.cuda.synchronize()`.

The comparison: the reference (perfbench/reference/train.py) follows
those first steps from the same weights, scene and seed; compared are
each step's loss, the first step's gradient as Adam holds it after that
step (its first moment over 1 − β1), and the parameters' change over the
steps, each by the worst leaf of |‖program‖ − ‖reference‖| over the
larger of ‖reference‖ and the median leaf's.
"""

from __future__ import annotations

import gc

import torch

from perfbench import scenes
from perfbench import weights as W
from perfbench.drivers.common import cell_config, program_config, sync
from perfbench.reference import train as rtrain

UNIT_SPAN = "step"
BETA1 = 0.9
# the host span of the optimizer's step (adam_ms reads its device time)
ADAM_SPAN = "Optimizer.step#Adam.step"


def _leaf_map(net) -> dict:
    """{"<layer>/kernel" | "<layer>/bias": parameter} of a NeRFMLP."""
    out = {}
    for name, layer in net.named_dense():
        out[name + "/kernel"] = layer.weight
        out[name + "/bias"] = layer.bias
    return out


def _numpy(trees: dict) -> dict:
    """Parameter trees with numpy leaves (the program's loader takes
    them)."""
    if isinstance(trees, dict):
        return {k: _numpy(v) for k, v in trees.items()}
    return trees.detach().cpu().numpy() if torch.is_tensor(trees) else trees


class Driver:
    """One training cell's program, window units (steps) and comparison."""

    unit_span = UNIT_SPAN
    watch = (ADAM_SPAN,)

    def __init__(self, cfg_doc: dict, traffic: dict, seed: int, device,
                 say):
        self.doc, self.traffic, self.seed = cfg_doc, traffic, seed
        self.device, self.say = device, say
        self.cfg = cell_config(cfg_doc, traffic)
        self.step_i = traffic["start_step"]
        self.checked = {}
        self.window_steps = []

    # --- the program ---------------------------------------------------------

    def setup(self, timer) -> None:
        from fashion_nerf_torch import kernels as K
        from fashion_nerf_torch.data.pipeline import ray_dataset
        from fashion_nerf_torch.train.loop import (TrainStep,
                                                   refresh_occupancy)
        from fashion_nerf_torch.train.state import state_from_params
        timer("import")
        self.pcfg = cfg = program_config(self.doc["preset"], self.cfg)
        if self.device.type == "cuda":
            K.library()
        timer("kernel library")
        self.scene = scenes.make(self.traffic["scene"], self.seed,
                                 self.device)
        sync(self.device)
        timer("scene")
        self.trees = _numpy(W.cell_trees(self.doc, self.seed, self.device))
        timer("weights")
        images = self.scene["images"].cpu().numpy()
        ds = ray_dataset(cfg, images, self.scene["poses"],
                         self.scene["focal"], device=self.device)
        self.all_rays = ds.batch_arrays()
        sync(self.device)
        timer("ray dataset")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = state_from_params(
            cfg, {k: self.trees[k] for k in ("coarse", "fine")}, gen,
            self.device)
        self.state.step = self.step_i
        self.dense = TrainStep(cfg, ds)
        self.fast = TrainStep(cfg, ds, occ_culled=True)
        self._refresh = refresh_occupancy
        self.occ = None
        self.start = {k: v.detach().float().cpu().clone()
                      for k, v in self._leaves().items()}
        sync(self.device)
        timer("train state and steps")

    def _leaves(self) -> dict:
        return {f"{n}/{k}": v for n in ("coarse", "fine")
                for k, v in _leaf_map(getattr(self.state, n)).items()}

    def _step(self):
        cfg, i = self.pcfg.train, self.state.step
        if cfg.occ_train and i >= cfg.occ_warmup and (
                self.occ is None or i % cfg.occ_refresh_every == 0):
            self.occ = self._refresh(self.pcfg, self.state)
        if self.occ is not None and (i + 1) % cfg.occ_dense_every != 0:
            _, metrics = self.fast(self.state, self.all_rays, self.occ)
        else:
            _, metrics = self.dense(self.state, self.all_rays)
        sync(self.device)
        return metrics

    def warm(self, timer) -> None:
        """The first check_steps steps: recorded for the comparison."""
        losses = []
        for n in range(self.traffic["check_steps"]):
            metrics = self._step()
            losses.append(float(metrics["loss"]))
            if n == 0:
                # the gradient as Adam holds it: its first moment after
                # one step over 1 − β1 (zero where it holds none)
                opt = self.state.optimizer
                self.checked["grad"] = {
                    k: (opt.state[p]["exp_avg"] / (1 - BETA1)).float().cpu()
                    if "exp_avg" in opt.state.get(p, {})
                    else torch.zeros(p.shape)
                    for k, p in self._leaves().items()}
        self.checked["losses"] = losses
        self.checked["delta"] = {
            k: v.detach().float().cpu() - self.start[k]
            for k, v in self._leaves().items()}
        timer("first steps (the compared ones, warm-up of both kinds)")
        from fashion_nerf_torch import kernels as K
        K.reset_launches()

    def unit(self, k: int) -> int:
        """One step of the window → its rays."""
        self.window_steps.append(self.state.step)
        self._step()
        return self.pcfg.train.batch_rays

    def release(self) -> None:
        from fashion_nerf_torch import kernels as K
        self.say("kernel launches in the window (the program's counters): "
                 + str({k: v for k, v in K.LAUNCHES.items() if v}))
        self.state = self.dense = self.fast = self.occ = None
        self.all_rays = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference -------------------------------------------------------

    def follow(self, quant=None) -> dict:
        rays = rtrain.scene_rays(self.scene["images"], self.scene["poses"],
                                 self.scene["focal"], self.device,
                                 self.cfg["render"]["ndc"])
        return rtrain.follow(self.cfg, self.trees, rays, self.seed,
                             self.traffic["start_step"],
                             self.traffic["check_steps"], self.device,
                             quant)

    def numbers(self, got: dict, want: dict) -> dict:
        """loss_gap: the worst step's |loss − reference| / reference;
        grad_gap, delta_gap: the worst leaf's gap of norms (of the first
        gradient, and of the change over the steps, the latter over the
        leaves the reference's gradient moves)."""
        want = {k: (v if not isinstance(v, dict) else
                    {n: t.float().cpu() for n, t in v.items()})
                for k, v in want.items()}
        moved = rtrain.moved_leaves(want["grad"])
        out = sorted(set(want["grad"]) - moved)
        self.say("leaves left out of delta_gap (reference gradient under "
                 f"1e-3 of the median leaf's): {out}")
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], want["losses"])),
            "grad_gap": rtrain.leaf_gap(got["grad"], want["grad"]),
            "delta_gap": rtrain.leaf_gap(got["delta"], want["delta"],
                                         moved)}

    def check(self, traced: bool) -> dict:
        """The numbers compared; when traced, each window step's field
        rows in self.counts (the train loop's schedule): train_rows, the
        rows forward and backward (each ray's coarse samples through the
        coarse net and coarse plus fine through the fine net, the prior's
        points through both); refresh_rows, the lattice swept through both
        nets on a refresh step."""
        t, s = self.cfg["train"], self.cfg["sampling"]
        B, G = t["batch_rays"], self.cfg["occupancy"]["resolution"]
        self.counts = []
        for i in (self.window_steps if traced else ()):
            on = t["occ_train"] and i >= t["occ_warmup"]
            culled = on and (i + 1) % t["occ_dense_every"] != 0
            n_c = t["occ_coarse"] if culled else s["n_coarse"]
            n_f = t["occ_fine"] if culled else s["n_fine"]
            prior = 2 * t["sparsity_points"] if t["sparsity_weight"] else 0
            self.counts.append({
                "culled": culled,
                "train_rows": B * (2 * n_c + n_f) + prior,
                "refresh_rows": (2 * G ** 3 if on and
                                 i % t["occ_refresh_every"] == 0 else 0)})
        return self.numbers(self.checked, self.follow())

    def control(self, quant: str) -> dict:
        """The reference at `quant` in the program's place."""
        self.scene = scenes.make(self.traffic["scene"], self.seed,
                                 self.device)
        self.trees = _numpy(W.cell_trees(self.doc, self.seed, self.device))
        low = self.follow(quant)
        return self.numbers(low, self.follow())

    def flops(self) -> dict:
        from perfbench.roofline import eval_flops
        return {k: eval_flops(v) for k, v in self.trees.items()
                if k in ("coarse", "fine")}

    def budget(self) -> tuple:
        return (0, 0)
