"""Checkpoints of the port: keep-last-N ∪ best-val_psnr retention, resume
that continues the identical trajectory, and kill-and-resume recovery with
`fault_at_step` (as tests/integration/test_resume.py does for the
reference). CPU, small nets."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config
from fashion_nerf_torch import ckpt
from fashion_nerf_torch.data.synthetic import make_synthetic_scene
from fashion_nerf_torch.prng import GeneratorChain
from fashion_nerf_torch.train.loop import train
from fashion_nerf_torch.train.state import create_train_state

torch.set_num_threads(2)

OVR = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
       "model.posenc_dir=2", "model.skips=", "train.batch_rays=32",
       "sampling.n_coarse=8", "sampling.n_fine=8", "sampling.perturb=true",
       "sampling.raw_noise_std=0.5", "train.sparsity_weight=1e-4",
       "train.sparsity_points=16", "train.occ_train=false",
       "train.precrop_iters=3", "train.log_every=10",
       "train.eval_every=1000", "train.ckpt_every=10"]


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=2, H=8, W=8, n_samples=16)


def _cfg(tmp_path, *ovr):
    cfg = load_config("blender_lego", OVR + list(ovr))
    return dataclasses.replace(cfg, out_dir=str(tmp_path))


def test_retention_keeps_latest_and_best(tmp_path):
    cfg = _cfg(tmp_path)
    chain = GeneratorChain(0)
    state = create_train_state(cfg, chain.once("init"), chain.once("run"))
    d = str(tmp_path / "ckpt")
    for step, val in ((1, 10.0), (2, 30.0), (3, None), (4, 12.0), (5, None),
                      (6, 11.0)):
        state.step = step
        ckpt.save(d, state, keep=2,
                  metrics=None if val is None else {"val_psnr": val})
    assert ckpt.steps(d) == [2, 5, 6]          # latest two ∪ best
    state.step = 7
    ckpt.save(d, state, keep=2, metrics={"val_psnr": 40.0})
    assert ckpt.steps(d) == [6, 7]
    assert ckpt.latest_step(d) == 7
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def _params(state):
    return {f"{k}.{n}": p.detach().clone() for k, net in state.nets().items()
            for n, p in net.named_parameters()}


def test_resume_continues_identical_trajectory(tmp_path, scene):
    """20 steps straight, against 10 steps, a restore into a fresh state,
    and 10 more: bitwise the same parameters, Adam moments and draws.
    Bitwise equality is the property, so both runs take one CPU thread: a
    loaded multi-threaded BLAS may split a sum differently between calls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight, _ = train(_cfg(tmp_path / "a", "train.iters=20"),
                            dataset_dict=scene, log_fn=lambda e: None,
                            device="cpu")
        train(_cfg(tmp_path / "b", "train.iters=10"), dataset_dict=scene,
              log_fn=lambda e: None, device="cpu")
        resumed, hist = train(_cfg(tmp_path / "b", "train.iters=20"),
                              dataset_dict=scene, log_fn=lambda e: None,
                              device="cpu", resume=True)
    finally:
        torch.set_num_threads(threads)
    assert resumed.step == straight.step == 20
    assert [h["step"] for h in hist if "loss" in h] == [20]
    a, b = _params(straight), _params(resumed)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())


def test_fault_then_resume(tmp_path, scene):
    cfg = _cfg(tmp_path, "train.iters=30", "train.seed=7")
    with pytest.raises(RuntimeError, match="injected fault"):
        train(cfg, dataset_dict=scene, log_fn=lambda e: None, device="cpu",
              fault_at_step=25)
    assert ckpt.steps(os.path.join(str(tmp_path), cfg.name, "ckpt")) == [
        10, 20]
    state, history = train(cfg, dataset_dict=scene, log_fn=lambda e: None,
                           device="cpu", resume=True)
    assert state.step == 30
    losses = [h["loss"] for h in history if "loss" in h]
    assert np.isfinite(losses).all()
    assert min(h["step"] for h in history if "loss" in h) == 30


def test_resume_without_checkpoint_starts_fresh(tmp_path, scene):
    state, _ = train(_cfg(tmp_path, "train.iters=5"), dataset_dict=scene,
                     log_fn=lambda e: None, device="cpu", resume=True)
    assert state.step == 5


def test_train_needs_cuda_unless_cpu_is_named(tmp_path, scene, monkeypatch):
    """train() and `cli train` take the CUDA device; without one they raise,
    unless the CPU is asked for by name."""
    from fashion_nerf_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path, "train.iters=1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, dataset_dict=scene, log_fn=lambda e: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, dataset_dict=scene, log_fn=lambda e: None, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", "tiny_lego", "--out", str(tmp_path),
                  "--set", "train.iters=1"])
    state, _ = train(cfg, dataset_dict=scene, log_fn=lambda e: None,
                     device="cpu")
    assert state.step == 1
