"""mip-NeRF 360's training generator: closed-loop training steps of the
program's `train/m360.py` step, held against
perfbench/reference/train_m360.py.

A traffic file with "driver": "train_m360" gives what one with "driver":
"train" gives (drivers/train.py: "scene", "overrides", "start_step",
"check_steps") and "pose_scale": the factor the cameras' positions are
scaled by for both sides after the scene is rendered (the images stay as
they are: the world is scaled about the origin). The configuration
document's weights are "seeded": the two nets' trees of
drivers/render_m360.py, drawn from the run's seed on the device, handed to
both sides.

The program: the trees through `train.m360.state_from_trees`, the ray set
of the scene (`RayDataset`), and one `M360TrainStep`, whose every step is
alike (no occupancy, no schedule but the learning rate's). The run's seed
seeds the step's generator. Set-up runs the first `check_steps` steps (the
compared ones, the warm-up of every shape), each ending with
`torch.cuda.synchronize()`; the window continues from there one step
ahead, as `train()` runs (which waits for no step): a unit launches a step
and waits for the one before it, and counts that one's rays, so the
host's share of a step (the rays, the Gaussians, the resampling, packing
the nets) runs under the card's work on the step before, and the count is
of steps completed in the window. The comparison is
drivers/train.py's: each step's loss, the first step's gradient as Adam
holds it (here the clipped one), the parameters' change over the steps,
by the worst leaf of both nets.

The work of a step is the same for any weights: every ray's two proposal
rounds of `proposal.eval_n` intervals and its `sampling.n_fine` NeRF
intervals, forward and backward; so the traced run's counts are exact
without the reference ("coarse_needed": proposal rows, "fine_needed": NeRF
rows, a step).

FAULTS: the planted faults of this driver's cell, for a harness that looks
them up here: the NeRF's (s, w) given gradients in the interlevel loss,
the distortion loss left out, and one trunk layer's kept activation of the
NeRF MLP replaced by the layer's below before the backward (its weight
gradient from a stale buffer; K7's backward on the card alone), the
losses taken over half the batch; perfbench/faults.py's training "stale"
(Adam a no-op) applies as it is.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from perfbench import scenes
from perfbench.drivers import train
from perfbench.drivers.common import program_config, sync
from perfbench.drivers.render_m360 import PROPOSAL_ROUNDS, seeded_trees
from perfbench.reference import train_m360 as rtrain

# the host ranges that the cell's per-layer metrics read
WATCH = ("fnt.kernel.wide_field", "fnt.kernel.prop_field",
         "fnt.kernel.wide_field_bwd", "fnt.kernel.prop_field_bwd",
         "fnt.step.losses")


class Driver(train.Driver):
    """The cell's program, window units (steps) and comparison."""

    watch = (train.ADAM_SPAN,) + WATCH

    def _scene(self):
        scene = scenes.make(self.traffic["scene"], self.seed, self.device)
        poses = np.array(scene["poses"], dtype=np.float32, copy=True)
        poses[:, :, 3] *= self.traffic.get("pose_scale", 1.0)
        return dict(scene, poses=poses)

    def setup(self, timer) -> None:
        from fashion_nerf_torch.train.m360 import (M360TrainStep,
                                                   state_from_trees)
        from fashion_nerf_torch import kernels as K
        from fashion_nerf_torch.data.pipeline import ray_dataset
        timer("import")
        self.pcfg = cfg = program_config(self.doc["preset"], self.cfg)
        if self.device.type == "cuda":
            K.library()
        timer("kernel library")
        self.scene = self._scene()
        sync(self.device)
        timer("scene")
        self.trees = seeded_trees(self.cfg, self.seed, self.device)
        timer("weights")
        ds = ray_dataset(cfg, self.scene["images"].cpu().numpy(),
                         self.scene["poses"], self.scene["focal"],
                         device=self.device)
        self.all_rays = ds.batch_arrays()
        sync(self.device)
        timer("ray dataset")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = state_from_trees(cfg, self.trees, gen, self.device)
        self.state.step = self.step_i
        self.trainer = M360TrainStep(cfg, ds)
        self._pending = None     # the window's step in flight
        self.start = {k: v.detach().float().cpu().clone()
                      for k, v in self._leaves().items()}
        sync(self.device)
        timer("train state and step")

    def _leaves(self) -> dict:
        return {f"{n}/{k}": v for n in ("proposal", "fine")
                for k, v in train._leaf_map(getattr(self.state, n)).items()}

    def _step(self):
        _, metrics = self.trainer(self.state, self.all_rays)
        sync(self.device)
        return metrics

    def unit(self, k: int) -> int:
        """One step of the window, one step ahead as `train()` runs them:
        step k is launched, then step k − 1 waited for; → the rays of the
        step that completed (none in the first unit, whose predecessor
        the warm-up already waited for)."""
        if self.device.type != "cuda":
            return super().unit(k)
        i = self.state.step
        self.trainer(self.state, self.all_rays)
        done = torch.cuda.Event()
        done.record()
        last, self._pending = self._pending, (i, done)
        if last is None:
            return 0
        last[1].synchronize()
        self.window_steps.append(last[0])
        return self.pcfg.train.batch_rays

    def release(self) -> None:
        sync(self.device)
        self.trainer = self._pending = None
        super().release()

    def follow(self, quant=None) -> dict:
        rays = rtrain.scene_rays(self.scene["images"], self.scene["poses"],
                                 self.scene["focal"], self.device)
        return rtrain.follow(self.cfg, self.trees, rays, self.scene["focal"],
                             self.seed, self.traffic["start_step"],
                             self.traffic["check_steps"], self.device, quant)

    def check(self, traced: bool) -> dict:
        """The numbers compared; when traced, each window step's rows in
        self.counts (module docstring)."""
        n_p, n_f = self.budget()
        B = self.cfg["train"]["batch_rays"]
        self.counts = [{"coarse_needed": B * n_p, "fine_needed": B * n_f}
                       for _ in (self.window_steps if traced else ())]
        return self.numbers(self.checked, self.follow())

    def control(self, quant: str) -> dict:
        """The reference at `quant` in the program's place."""
        self.scene = self._scene()
        self.trees = seeded_trees(self.cfg, self.seed, self.device)
        low = self.follow(quant)
        return self.numbers(low, self.follow())

    def flops(self) -> dict:
        """Operations per evaluation of each net ("proposal", "fine"), and
        of its backward with the bytes a row of it reads ("<net>_bwd",
        "<net>_bwd_bytes"; perfbench/m360_counts.py)."""
        from perfbench import m360_counts
        from perfbench.roofline import eval_flops
        trees = (self.trees if getattr(self, "trees", None) is not None
                 else seeded_trees(self.cfg, self.seed, "cpu"))
        cd = 3 + 6 * self.cfg["model"]["posenc_dir"]
        out = {}
        for k, v in trees.items():
            out[k] = eval_flops(v)
            out[k + "_bwd"] = m360_counts.bwd_flops(v, cd)
            out[k + "_bwd_bytes"] = m360_counts.bwd_bytes(v)
        return out

    def budget(self) -> tuple:
        """(proposal, NeRF) evaluations a ray and step."""
        return (PROPOSAL_ROUNDS * self.cfg["proposal"]["eval_n"],
                self.cfg["sampling"]["n_fine"])


# --- planted faults ---------------------------------------------------------

@contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def interlevel_to_nerf():
    """The interlevel loss without the stop-gradient on the NeRF's (s, w):
    its gradient reaches the NeRF MLP."""
    from fashion_nerf_torch.train import m360

    def make(old):
        def f(s, w, s_p, w_p):
            excess = torch.clamp(w - m360.interlevel_bound(s, s_p, w_p),
                                 min=0.0)
            return (excess * excess / (w + m360.INTERLEVEL_EPS)).sum(
                -1).mean()
        return f
    return _patched(m360, "interlevel", make)


def no_distortion():
    """The distortion loss left out."""
    from fashion_nerf_torch.train import m360

    def make(old):
        def f(s, w):
            return w.sum() * 0.0
        return f
    return _patched(m360, "distortion", make)


def stale_activation(layer: int = 5):
    """The NeRF MLP's kept output of trunk layer `layer` overwritten by the
    layer's below before the backward: the next layer's weight gradient
    (and this layer's ReLU mask) read a stale buffer."""
    from fashion_nerf_torch.kernels import widefield

    def make(old):
        def f(net, saved, *a, **k):
            if net.has_vd:
                hs = saved["hs"].view(net.depth, -1)
                hs[layer].copy_(hs[layer - 1])
            return old(net, saved, *a, **k)
        return f
    return _patched(widefield, "_run_backward", make)


def half_batch():
    """The step's losses taken over the first half of the batch's rays."""
    from fashion_nerf_torch.train import m360

    def make(old):
        def f(cfg, out, target):
            n = target.shape[0] // 2
            half = {"rgb": out["rgb"][:n], "s": out["s"][:n],
                    "w": out["w"][:n],
                    "rounds": [(s[:n], w[:n]) for s, w in out["rounds"]]}
            return old(cfg, half, target[:n])
        return f
    return _patched(m360, "losses", make)


def adam_noop():
    """Adam's step a no-op: the state left unchanged."""
    from perfbench import faults
    return faults.train_stale()


FAULTS = {"interlevel_to_nerf": interlevel_to_nerf,
          "no_distortion": no_distortion,
          "stale_activation": stale_activation, "half_batch": half_batch,
          "stale": adam_noop}
