"""Training the try-on presets with the port on the CPU (the plain versions
of every kernel), small: `train()` and `python -m fashion_nerf_torch train`
of `viton_tryon` and `dynamic_tryon`, the checkpoint's `eval`, and the
pieces a conditioned run must carry: the garment into the evaluation, the
per-scene cond into the occupancy refresh, the first ray's cond into the
sparsity prior (a reference caveat the port copies), and the trained
frames' latents. The reference checks the same of its own trainer
(tests/integration/test_tryon_configs.py:24-50)."""

import json
import os

import numpy as np
import pytest
import torch

from fashion_nerf_torch import cli
from fashion_nerf_torch import ckpt as ckpt_lib
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import create_train_state

torch.set_num_threads(2)

PRESETS = ("viton_tryon", "dynamic_tryon")
SMALL = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
         "model.condition_dim=16", "model.latent_dim=8",
         "sampling.n_coarse=16", "sampling.n_fine=16",
         "train.batch_rays=64", "train.sparsity_points=64",
         "train.precrop_iters=0", "train.iters=6", "train.log_every=2",
         "train.eval_every=6", "train.ckpt_every=6", "train.occ_train=true",
         "train.occ_warmup=2", "train.occ_refresh_every=1000",
         "train.occ_dense_every=3", "occupancy.resolution=16",
         "render.eval_n_coarse=16", "render.eval_n_fine=16",
         "proposal.distill_steps=2", "proposal.distill_batch=64"]


def _small(preset):
    """SMALL, and for dynamic_tryon a 16-code latent table (more codes than
    the 5 frames, so some are never trained)."""
    return SMALL + (["model.n_latents=16"] if preset == "dynamic_tryon"
                    else [])


def _cfg(preset, out, *ovr):
    return load_config(preset, _small(preset) + [f"out_dir={out}", *ovr])


def _scene(preset):
    """The preset's hermetic dataset, small: the viton scene with its
    garment stack, or the procedural scene (no garment of its own)."""
    if preset == "viton_tryon":
        from fashion_nerf_torch.data.viton import load_viton_scene
        return load_viton_scene("", n_views=5, H=16, W=16,
                                cfg=load_config(preset))
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    return make_synthetic_scene(n_views=5, H=16, W=16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """train() of both presets, with the garment handed to `evaluate` and
    the cond vector handed to `refresh_occupancy` recorded."""
    out = {}
    for preset in PRESETS:
        seen = {"eval": [], "refresh": []}
        ev0, rf0 = loop.evaluate, loop.refresh_occupancy

        def ev(*a, garment=None, **kw):
            seen["eval"].append(garment)
            return ev0(*a, garment=garment, **kw)

        def rf(cfg, state, cond_vec=None):
            seen["refresh"].append((cond_vec, loop._eval_cond(
                cfg, state.nets(), garment0)))
            return rf0(cfg, state, cond_vec=cond_vec)

        d = str(tmp_path_factory.mktemp(preset))
        cfg = _cfg(preset, d)
        scene = _scene(preset)
        garment0 = loop.resolve_garment(cfg, scene, 16, 16)
        init = create_train_state(cfg, *_generators(cfg))
        logs = []
        loop.evaluate, loop.refresh_occupancy = ev, rf
        try:
            with torch.enable_grad():
                state, hist = loop.train(cfg, dataset_dict=scene,
                                         log_fn=logs.append, device="cpu")
        finally:
            loop.evaluate, loop.refresh_occupancy = ev0, rf0
        out[preset] = dict(cfg=cfg, state=state, hist=hist, logs=logs,
                           seen=seen, garment=garment0, init=init, dir=d,
                           scene=scene)
    return out


def _generators(cfg):
    from fashion_nerf_torch.prng import GeneratorChain
    chain = GeneratorChain(cfg.train.seed)
    return chain.once("init"), chain.once("run", "cpu")


@pytest.mark.parametrize("preset", PRESETS)
def test_train_tryon_preset_on_cpu(runs, preset):
    """The log lines (JSON-able, finite, the culled and dense steps and a
    refresh counted), one eval, a checkpoint holding the encoder (and the
    latent table) that restores; the encoder moved; of the latent table,
    the trained frames' codes moved and drifted apart, the others did
    not."""
    r = runs[preset]
    logs = [h for h in r["hist"] if "loss" in h]
    assert len(logs) == 3 and all(np.isfinite(h["loss"]) for h in logs)
    json.dumps(r["logs"])
    last = logs[-1]
    assert (last["refreshes"], last["culled_steps"] > 0,
            last["dense_steps"] > 0) == (1, True, True)
    evals = [h["val_psnr"] for h in r["hist"] if "val_psnr" in h]
    assert len(evals) == 1 and np.isfinite(evals[0])
    ckpt_dir = os.path.join(r["dir"], preset, "ckpt")
    assert ckpt_lib.steps(ckpt_dir) == [6]
    payload = torch.load(os.path.join(ckpt_dir, "step_00000006.pt"),
                         weights_only=True)
    want = {"coarse", "fine", "encoder"} | (
        {"latents"} if preset == "dynamic_tryon" else set())
    assert set(payload["nets"]) == want
    state, init = r["state"], r["init"]
    enc = state.encoder.convs[0].weight.detach()
    assert float((enc - init.encoder.convs[0].weight.detach()).abs().max()
                 ) > 0.0
    if preset == "dynamic_tryon":
        codes = state.latents.codes.weight.detach()
        codes0 = init.latents.codes.weight.detach()
        moved = (codes - codes0).abs().amax(dim=1)
        n_frames = len(r["scene"]["poses"])
        assert bool((moved[:n_frames] > 0).all())
        assert float(moved[n_frames:].max()) == 0.0
        drift = (codes[0] - codes[1]) - (codes0[0] - codes0[1])
        assert float(drift.abs().max()) > 0.0
    else:
        assert state.latents is None


@pytest.mark.parametrize("preset", PRESETS)
def test_train_evaluates_with_the_garment(runs, preset):
    """train()'s evaluation renders with the run's garment stack (the
    reference's train/loop.py:417), not without its cond."""
    r = runs[preset]
    assert len(r["seen"]["eval"]) == 1
    g = r["seen"]["eval"][0]
    assert g is not None and torch.equal(g, r["garment"])


@pytest.mark.parametrize("preset", PRESETS)
def test_train_refreshes_occupancy_with_the_cond(runs, preset, monkeypatch):
    """train()'s occupancy refresh sweeps with the per-scene cond vector of
    the live nets (the reference's train/loop.py:395-397), and
    refresh_occupancy calls both fields with it."""
    r = runs[preset]
    (got, want), = r["seen"]["refresh"]
    assert got is not None and torch.equal(got, want)
    cfg, state = r["cfg"], r["state"]
    calls = []
    field0 = loop.field_for(cfg)

    def spy(net, pts, dirs, *cond):
        calls.append(tuple(c.shape for c in cond))
        return field0(net, pts, dirs, *cond)

    monkeypatch.setattr(loop, "field_for", lambda cfg: spy)
    with torch.no_grad():
        cond = loop._eval_cond(cfg, state.nets(), r["garment"])
    occ = loop.refresh_occupancy(cfg, state, cond_vec=cond)
    assert calls and all(c == ((c[0][0], cond.shape[0]),) for c in calls)
    assert occ.grid.shape == (16, 16, 16)


@pytest.mark.parametrize("preset", PRESETS)
def test_sparsity_prior_takes_the_first_rays_cond(runs, preset):
    """Reference caveat, pinned (train/loop.py:152-154): the sparsity prior
    conditions every prior point on cond[:1], the first ray's cond; for
    dynamic_tryon that is one frame's latent a step. The step's prior is
    that of its own cond: a batch whose first two rays have different
    frames gives the first ray's prior, not the second's."""
    r = runs[preset]
    cfg, state = r["cfg"], r["state"]
    fc = ff = loop.field_for(cfg, training=True)
    batch = {k: v[[0, 300, 5, 7]] for k, v in _rays(r["scene"]).items()}
    assert batch["frame_ids"][0] != batch["frame_ids"][1]
    pts = torch.rand((64, 1, 3), generator=torch.Generator().manual_seed(0))
    pts = 2.0 * pts - 1.0
    nets = state.nets()
    with torch.no_grad():
        cond = loop.make_cond(cfg, nets, batch, r["garment"])
        sp = loop.sparsity_loss(cfg, nets, fc, ff, pts, cond)
        first = loop.sparsity_loss(cfg, nets, fc, ff, pts, cond[:1])
        second = loop.sparsity_loss(cfg, nets, fc, ff, pts, cond[1:2])
        none = loop.sparsity_loss(cfg, nets, fc, ff, pts)
        step = loop.TrainStep(cfg, _dataset(r["scene"]), streamed=True,
                              garment=r["garment"])
        _, aux = step.loss(state, batch, sparsity_pts=pts)
    assert float(sp) == float(first) == float(aux["sparsity"])
    assert float(none) != float(sp)
    if preset == "dynamic_tryon":
        assert float(second) != float(first)
    else:                         # one garment code for every ray
        assert float(second) == float(first)


def _dataset(scene):
    from fashion_nerf_torch.data.pipeline import RayDataset
    return RayDataset(scene["images"], scene["poses"], scene["focal"])


def _rays(scene):
    return _dataset(scene).batch_arrays()


def _argv(cmd, preset, out, *ovr):
    argv = [cmd, "--config", preset, "--device", "cpu", "--out", out]
    for kv in _small(preset) + list(ovr):
        argv += ["--set", kv]
    return argv


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_train_then_eval_tryon(tmp_path, capsys, preset):
    """`python -m fashion_nerf_torch train --config viton_tryon` (and
    dynamic_tryon) on the CPU: two JSON log lines, the summary line, a
    checkpoint with the encoder, then `eval` (one JSON row, finite PSNR)
    and `render` (a PNG a pose) of that checkpoint; the same with --device
    left out raises without CUDA."""
    out = str(tmp_path)
    scene = _scene(preset)
    argv = _argv("train", preset, out, "train.iters=4", "train.log_every=2",
                 "train.ckpt_every=4", "train.eval_every=100")
    assert cli.main(argv, dataset=scene) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["steps"] == 4
    assert sum(line.startswith('[fashion-nerf-torch] {"loss"')
               for line in lines) == 2
    assert ckpt_lib.steps(os.path.join(out, preset, "ckpt")) == [4]
    assert cli.main(_argv("eval", preset, out), dataset=scene) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["n_views"] == 1 and np.isfinite(row["psnr"])
    assert cli.main(_argv("render", preset, out), dataset=scene) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == len(scene["poses"])
    assert os.path.exists(os.path.join(res["out"], "000.png"))
    no_dev = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(no_dev, dataset=scene)
