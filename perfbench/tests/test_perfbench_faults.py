"""A run with its timed path broken underneath comes out not correct: the
harness driven on the CPU (the program's plain versions) at a tiny size,
once for each fault each cell can have (perfbench/faults.py)."""

import json
import os

import pytest
import torch

from perfbench import ROOT, faults, harness

TINY_RENDER = {"frame": [32, 32], "warm_frames": 1, "check_frames": 2}
TINY_TRAIN = {"scene": {"kind": "forward", "n_views": 3, "H": 24, "W": 32,
                        "scale": 1.0, "sharp": 25.0, "texture": 0.0},
              "overrides": {"train.batch_rays": 256}}
# the program's float32 field (no fused bf16 kernels) for the sound tiny
# run: at a batch of 256 rays the bf16 gradient's gap to the reference is
# batch noise near the limit set at the cell's 16,384 rays (the card's
# runs hold the bf16 path at the cell's size)
F32_FIELD = {"kernels.fused_mlp": False, "model.compute_dtype": "float32"}


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def tiny(cell, sound=False):
    if cell.traffic["driver"] != "train":
        return TINY_RENDER
    if not sound:
        return TINY_TRAIN
    return dict(TINY_TRAIN, overrides=dict(TINY_TRAIN["overrides"],
                                           **F32_FIELD))


def run(cell, seed, seconds=0.5, sound=False):
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            0.0, traffic_overrides=tiny(cell, sound))


CASES = [(w, f) for w in cells() for f in ("altered", "half", "stale")
         # every frame of the bench-pose traffic is the same frame: a stale
         # one is a right one
         if not (w.startswith("fern.render") and f == "stale")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_not_correct(workload, fault):
    cell = harness.Cell.load(workload)
    with faults.FAULTS[cell.traffic["driver"]][fault]():
        r = run(cell, 2 ** 31 + 11)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", cells())
def test_without_a_fault_it_is_correct(workload):
    cell = harness.Cell.load(workload)
    r = run(cell, 2 ** 31 + 11, sound=True)
    assert r["correct"], r["checks"]
