"""Checkpoint and resume; counterpart of `fashion_nerf.ckpt`.

A checkpoint is one `torch.save` file per step, `step_<N>.pt`, holding the
whole TrainState: both nets, Adam's moments, the step and the state of
the step's generator, so resume continues the identical trajectory. A
checkpoint restores on either kind of device; a generator's state is
particular to its kind, so across kinds the draws go on from the template's
generator and only the trajectory's identity is lost.
Retention keeps the latest `keep` checkpoints and, beside them, the one
with the best `val_psnr` among those saved with one (the reference's
LatestN ∪ BestN policy). The metrics of the kept steps live in
`metrics.json` beside them.

Under a mesh every rank calls `save` and `restore`: a checkpoint holds
full tensors (a tensor-parallel optimizer's state_dict gathers its
moments),
rank 0 alone writes it, and every rank reads it, so one written by ranks
restores in one process and the reverse.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from fashion_nerf_torch.dist.mesh import is_main

_NAME = re.compile(r"^step_(\d+)\.pt$")
_INDEX = "metrics.json"


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def steps(directory: str) -> list:
    """Saved steps, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    s = steps(directory)
    return s[-1] if s else None


def _read_index(directory: str) -> dict:
    path = os.path.join(directory, _INDEX)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def _write_index(directory: str, index: dict) -> None:
    path = os.path.join(directory, _INDEX)
    with open(path + ".tmp", "w") as f:
        json.dump({str(k): v for k, v in sorted(index.items())}, f)
    os.replace(path + ".tmp", path)


def save(directory: str, state, keep: int = 3,
         metrics: Optional[dict] = None) -> int:
    """Save `state` at its step, then prune to the retention policy (on
    rank 0; the other ranks take part in gathering the state only)."""
    optimizer = state.optimizer.state_dict()    # a collective under tp
    if not is_main():
        return state.step
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": state.step,
        "nets": {k: v.state_dict() for k, v in state.nets().items()},
        "optimizer": optimizer,
        "generator": state.generator.get_state(),
        "generator_device": state.generator.device.type,
    }
    path = _path(directory, state.step)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    index = _read_index(directory)
    index[state.step] = dict(metrics or {})
    all_steps = steps(directory)
    kept = set(all_steps[-keep:]) if keep > 0 else set()
    scored = [s for s in all_steps if "val_psnr" in index.get(s, {})]
    if scored:
        kept.add(max(scored, key=lambda s: index[s]["val_psnr"]))
    for s in all_steps:
        if s not in kept:
            os.remove(_path(directory, s))
    _write_index(directory, {s: index.get(s, {}) for s in kept})
    return state.step


def restore(directory: str, state, step: Optional[int] = None):
    """Load the latest (or the given) checkpoint into `state` in place."""
    step = latest_step(directory) if step is None else step
    if step is None or not os.path.exists(_path(directory, step)):
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    payload = torch.load(_path(directory, step), map_location="cpu",
                         weights_only=True)
    for name, net in state.nets().items():
        net.load_state_dict(payload["nets"][name])
    state.optimizer.load_state_dict(payload["optimizer"])
    kind = state.generator.device.type
    if payload.get("generator_device", kind) == kind:
        state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state
