"""Faults planted under the timed path, for the check that the comparison
catches them (perfbench/tests/test_perfbench_faults.py, and
perfbench/calibrate.py --fault on the card).

Each is a context manager that patches the program while it is open:

- "altered": an answer altered where it is produced: every live chunk's
  rgb + 0.1 (render); the rendered batch's fine rgb + 0.02 (training);
- "half": half of the batch left out: every other ray of a chunk not
  marched, given the background (render); the loss the mean over the
  batch's first half (training);
- "stale": a step that returns its state unchanged: every frame the first
  one rendered (render); Adam's step a no-op (training).
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def render_altered():
    from fashion_nerf_torch.render import blockwise

    def make(old):
        def f(*a, **k):
            out = old(*a, **k)
            out["fine"]["rgb"] = out["fine"]["rgb"] + 0.1
            return out
        return f
    return _patched(blockwise, "render_rays_blockwise", make)


def render_half():
    from fashion_nerf_torch.render import blockwise

    def make(old):
        def f(*a, **k):
            out = old(*a, **k)
            fine = out["fine"]
            bg = 1.0 if a[1].render.white_bkgd else 0.0
            fine["rgb"] = fine["rgb"].clone()
            fine["rgb"][1::2] = bg
            fine["acc"] = fine["acc"].clone()
            fine["acc"][1::2] = 0.0
            return out
        return f
    return _patched(blockwise, "render_rays_blockwise", make)


def render_stale():
    from fashion_nerf_torch.render import blockwise
    first = []

    def make(old):
        def f(*a, **k):
            if not first:
                first.append(old(*a, **k))
            return first[0]
        return f
    return _patched(blockwise, "render_image_blockwise", make)


def train_altered():
    from fashion_nerf_torch.train import loop

    def make(old):
        def f(*a, **k):
            out = old(*a, **k)
            out["fine"]["rgb"] = out["fine"]["rgb"] + 0.02
            return out
        return f
    return _patched(loop, "render_rays", make)


def train_half():
    from fashion_nerf_torch.train import loop

    def make(old):
        def f(self, rgb, target):
            n = rgb.shape[0] // 2
            return old(self, rgb[:n], target[:n])
        return f
    return _patched(loop.TrainStep, "_mse", make)


def train_stale():
    import torch

    def make(old):
        def f(self, *a, **k):
            return None
        return f
    return _patched(torch.optim.Adam, "step", make)


FAULTS = {
    "render": {"altered": render_altered, "half": render_half,
               "stale": render_stale},
    "train": {"altered": train_altered, "half": train_half,
              "stale": train_stale},
}
