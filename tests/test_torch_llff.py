"""`llff_fern` through the port on the CPU, at the widths of
tests/integration/test_ndc_training.py (2×32, L = 4, 16 + 16 samples),
against the JAX reference:

- one training step on NDC rays (σ noise off, `raw_noise_std=0`, so the
  two sides compute the same loss): the loss within 1e-4 relative over
  two Adam steps, the reference's fused field in Pallas interpret mode and
  the port's K3/K4 plain versions;
- σ noise (`raw_noise_std=1`) is drawn in training and not in eval;
- `cli eval` and `render` of a checkpoint that holds the reference's
  weights, through the two-stage blockwise march with NDC, against the
  reference's dense render of the same weights (PSNR within 0.05 dB, the
  frames ≥ 40 dB: the two differ only by early termination at ε = 1e-3),
  and `eval` against the port's own dense eval (`kernels.use_pallas=false`);
- `cli train` → `eval` on the hermetic forward scene, `train` → `eval` →
  `render` on a `data.root` LLFF fixture (the loader), and `cli parity`
  over a root of two LLFF scenes, each scene's checkpoint from
  `train --out <out>/<scene>`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf import metrics as jmetrics
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.data.pipeline import RayDataset as JRayDataset
from fashion_nerf.render import renderer as jrenderer
from fashion_nerf.train import loop as jloop
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch import ckpt as ckpt_lib
from fashion_nerf_torch import cli, png
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.data.synthetic import make_forward_scene
from fashion_nerf_torch.kernels.posenc_mlp import field_for
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.render import renderer
from fashion_nerf_torch.train import loop
from fashion_nerf_torch.train.state import TrainState, make_optimizer
from test_torch_loaders import write_llff

torch.set_num_threads(2)

SMALL = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=4",
         "model.posenc_dir=2", "model.skips=", "sampling.n_coarse=16",
         "sampling.n_fine=16", "kernels.interpret=true",
         "train.precrop_iters=0"]


@pytest.fixture(scope="module")
def scene():
    return make_forward_scene(n_views=3, H=16, W=24, n_samples=32)


def _port_state(cfg, params):
    nets = {k: load_flax_params(jax.device_get(params[k]),
                                compute_dtype=cfg.model.compute_dtype)
            for k in ("coarse", "fine")}
    ps = [p for n in nets.values() for p in n.parameters()]
    return TrainState(step=0, coarse=nets["coarse"], fine=nets["fine"],
                      optimizer=make_optimizer(cfg, ps),
                      generator=torch.Generator().manual_seed(0))


def test_ndc_step_matches_reference(scene):
    ovr = SMALL + ["sampling.raw_noise_std=0.0", "sampling.perturb=false",
                   "train.batch_rays=64"]
    cfg_j, cfg = j_load_config("llff_fern", ovr), load_config("llff_fern",
                                                              ovr)
    assert cfg.render.ndc
    jds = JRayDataset(scene["images"], scene["poses"], scene["focal"],
                      ndc=True)
    tds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                     ndc=True)
    idx = np.random.default_rng(0).choice(jds.n_rays, 64, replace=False)
    jb = {k: v[idx] for k, v in jds.batch_arrays().items()}
    tb = {k: v[torch.from_numpy(idx)] for k, v in tds.batch_arrays().items()}
    jstate = j_create(cfg_j, jax.random.PRNGKey(0))
    port = _port_state(cfg, jax.device_get(jstate.params))
    jstep = jloop.make_train_step(cfg_j, jds, streamed=True)
    step = loop.TrainStep(cfg, tds, streamed=True)
    for _ in range(2):
        jstate, m = jstep(jstate, jb)
        port, mt = step(port, tb)
        lj, lt = float(m["loss"]), float(mt["loss"])
        assert abs(lt - lj) <= 1e-4 * abs(lj), (lt, lj)


def test_sigma_noise_in_training_only(scene):
    """The same rays and nets: two training renders with σ noise 1 and
    different generators differ; the eval render with noise 1 equals the
    eval render with noise 0 bit for bit."""
    cfg = load_config("llff_fern", SMALL + ["sampling.raw_noise_std=1.0"])
    cfg0 = load_config("llff_fern", SMALL + ["sampling.raw_noise_std=0.0"])
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    ndc=True)
    b = {k: v[:64] for k, v in ds.batch_arrays().items()}
    port = _port_state(cfg, jax.device_get(
        j_create(j_load_config("llff_fern", SMALL),
                 jax.random.PRNGKey(1)).params))
    fc = ff = field_for(cfg)
    v = b["viewdirs"]

    def run(c, train, seed):
        with torch.no_grad():
            return renderer.render_rays(
                lambda p, _d: fc(port.coarse, p, v),
                lambda p, _d: ff(port.fine, p, v), b["rays_o"], b["rays_d"],
                c, train=train,
                generator=torch.Generator().manual_seed(seed))["fine"]["rgb"]

    assert not torch.equal(run(cfg, True, 1), run(cfg, True, 2))
    assert torch.equal(run(cfg, False, 1), run(cfg0, False, 2))


def _set(overrides):
    return [x for kv in overrides for x in ("--set", kv)]


def test_cli_eval_render_match_reference(scene, tmp_path, capsys):
    cfg_j = j_load_config("llff_fern", SMALL)
    cfg = load_config("llff_fern", SMALL + [f"out_dir={tmp_path}"])
    jstate = j_create(cfg_j, jax.random.PRNGKey(2))
    ckpt_lib.save(os.path.join(str(tmp_path), cfg.name, "ckpt"),
                  _port_state(cfg, jstate.params))
    field_c, field_f = jloop.make_fields(cfg_j)
    val = jrenderer.render_image(
        lambda p, d, c=None: field_c(jstate.params["coarse"], p, d),
        lambda p, d, c=None: field_f(jstate.params["fine"], p, d),
        scene["H"], scene["W"], scene["focal"],
        jnp.asarray(scene["val_pose"]), cfg_j)["rgb"]
    want = float(jmetrics.psnr(val, jnp.asarray(scene["val_image"])))
    argv = ["eval", "--config", "llff_fern", "--device", "cpu", "--out",
            str(tmp_path)] + _set(SMALL)
    rows = []
    for extra in ([], ["kernels.use_pallas=false"]):
        assert cli.main(argv + _set(extra), dataset=scene) == 0
        rows.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert abs(rows[0]["psnr"] - want) <= 0.05, (rows, want)
    assert abs(rows[0]["psnr"] - rows[1]["psnr"]) <= 0.05, rows
    # render: the scene's poses through the two-stage march, each PNG
    # ≥ 40 dB against the reference's dense frame (8-bit rounding ~59 dB)
    frames = np.asarray(jrenderer.render_path(
        lambda p, d, c=None: field_c(jstate.params["coarse"], p, d),
        lambda p, d, c=None: field_f(jstate.params["fine"], p, d),
        scene["poses"], scene["H"], scene["W"], scene["focal"], cfg_j))
    argv[0] = "render"
    assert cli.main(argv, dataset=scene) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == len(frames) == 3
    for i, want_f in enumerate(frames):
        got = png.read_png(os.path.join(res["out"], f"{i:03d}.png"))
        assert float(psnr(torch.from_numpy(got / 255.0), torch.from_numpy(
            np.clip(want_f, 0, 1)))) >= 40.0


def _train(common, extra=(), dataset=None):
    train = ["train.batch_rays=64", "train.iters=3", "train.log_every=1",
             "train.ckpt_every=3", "train.eval_every=100"]
    return cli.main(["train"] + common + _set(train + list(extra)),
                    dataset=dataset)


def test_cli_train_eval_hermetic(tmp_path, capsys):
    """The hermetic forward scene (`load_dataset` without data.root, 12
    views of 96×128): train with σ noise on (the preset's 1.0), eval
    through the two-stage march."""
    common = ["--config", "llff_fern", "--device", "cpu", "--out",
              str(tmp_path)] + _set(SMALL)
    assert _train(common) == 0
    out = capsys.readouterr().out.strip().splitlines()
    losses = [json.loads(x.split(" ", 1)[1])["loss"] for x in out
              if x.startswith("[fashion-nerf-torch] {\"loss\"")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert cli.main(["eval"] + common) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(row["psnr"]) and row["n_views"] == 1


def test_cli_on_llff_root_and_parity(tmp_path, capsys):
    """`data.root` of one LLFF scene: train, eval (its anchor row: the
    scene is not one of the paper's), render of the 40-view spiral; then
    `parity` over a root of two scenes, their checkpoints trained with
    `--out <out>/<scene>`."""
    root = tmp_path / "root"
    for i, name in enumerate(("fern", "orchids")):
        write_llff(root / name, H=16, W=24, n=6, seed=i)
    small = SMALL + ["data.llff_factor=1"]
    out = tmp_path / "out"
    for name in ("fern", "orchids"):
        common = ["--config", "llff_fern", "--device", "cpu", "--out",
                  str(out / name)] + _set(small + [f"data.root={root / name}"])
        assert _train(common) == 0
    capsys.readouterr()
    assert cli.main(["eval"] + common) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["n_views"] == 1 and row["anchor_psnr"] == 20.36
    assert cli.main(["render"] + common) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 40
    img = png.read_png(os.path.join(res["out"], "039.png"))
    assert img.shape == (16, 24, 3) and img.std() > 0
    argv = ["parity", "--config", "llff_fern", "--device", "cpu", "--out",
            str(out)] + _set(small + [f"data.root={root}"])
    assert cli.main(argv) == 0
    rows = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["scene"] for r in rows[:2]] == ["fern", "orchids"]
    assert rows[0]["anchor_psnr"] == 25.17 and rows[1]["anchor_psnr"] == 20.36
    assert rows[2]["scenes"] == 2
    assert all(np.isfinite(r["psnr"]) for r in rows[:2])
