"""The port's `render` / `eval` / `parity` / `bench` entry points and the
proposal distillation against the JAX reference, on the CPU at small sizes
(nets 2×32 and 3×32, 8 or 16 samples, 16×16 frames):

- the distillation loss against the reference's `loss_fn` on the same
  points and weights (1e-5 relative), its points, its determinism and its
  convergence on an analytic teacher; `attach_proposal`'s branches;
- `render_path` against the reference's on two poses (≥ 40 dB);
- `eval` and `render` through `cli.main` from a checkpoint that holds the
  reference's weights: PSNR within 0.05 dB and SSIM within 1e-3 of the
  reference's `render_image` + metrics, the PNGs ≥ 40 dB against the
  reference's frames;
- `train → eval → render` through `cli.main` on `tiny_lego`, and `eval` of a
  small `blender_lego` through the blockwise path with a distilled proposal;
- the parser's subcommands and flags, the refusals, the PNG writer, and a
  checkpoint restored on the other kind of device.

The reference runs its XLA fields (its kernels are off on the CPU); the
port runs its plain versions."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf import cli as jcli
from fashion_nerf import metrics as jmetrics
from fashion_nerf.assets import load_flagship
from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.data.synthetic import make_synthetic_scene
from fashion_nerf.models.nerf_mlp import init_field as j_init_field
from fashion_nerf.models.nerf_mlp import make_field as j_make_field
from fashion_nerf.models.proposal import proposal_model_config as j_pmc
from fashion_nerf.render import renderer as jrenderer
from fashion_nerf.train import loop as jloop
from fashion_nerf.train.state import create_train_state as j_create
from fashion_nerf_torch import ckpt as ckpt_lib
from fashion_nerf_torch import cli
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch import png
from fashion_nerf_torch.config import config_to_dict, load_config
from fashion_nerf_torch.kernels.posenc_mlp import field_for
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models import proposal
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.render import renderer
from fashion_nerf_torch.train.state import TrainState, make_optimizer

torch.set_num_threads(2)

# a dense two-pass config: 2×32 net with view directions, 8 + 8 samples
DENSE = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
         "model.use_viewdirs=true", "model.skips=", "sampling.n_coarse=8",
         "sampling.n_fine=8", "render.chunk=128", "data.root="]
# a small proposal net and a short distillation
PROP = ["proposal.net_width=32", "proposal.posenc_xyz=2",
        "proposal.distill_batch=256", "model.compute_dtype=float32"]


def _set(overrides):
    return [x for kv in overrides for x in ("--set", kv)]


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=2, H=16, W=16, n_samples=32)


def _port_state(cfg, params):
    nets = {k: load_flax_params(jax.device_get(params[k]),
                                compute_dtype=cfg.model.compute_dtype)
            for k in ("coarse", "fine")}
    ps = [p for n in nets.values() for p in n.parameters()]
    return TrainState(step=0, coarse=nets["coarse"], fine=nets["fine"],
                      optimizer=make_optimizer(cfg, ps),
                      generator=torch.Generator().manual_seed(0))


# --- proposal distillation ---------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_distill_loss_matches_reference(act):
    """The reference's `loss_fn` (models/proposal.py:100-102) on the same
    numpy points, targets and weights: 1e-5 relative (f32)."""
    ovr = PROP + [f"model.sigma_activation={act}"]
    jcfg = j_load_config("blender_lego", ovr)
    pm = j_pmc(jcfg)
    tree = j_init_field(jax.random.PRNGKey(3), pm)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.5, 1.5, (256, 1, 3)).astype(np.float32)
    y = rng.uniform(0.0, 3.0, 256).astype(np.float32)
    _, pfield = j_make_field(pm)
    dirs = jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (256, 3))
    _, s_raw = pfield(tree, jnp.asarray(pts), dirs, None)
    jact = jax.nn.softplus if act == "softplus" else jax.nn.relu
    want = float(jnp.mean((jnp.log1p(jact(s_raw[:, 0])) - y) ** 2))
    student = load_flax_params(jax.device_get(tree))
    got = float(proposal.distill_loss(student, torch.from_numpy(pts),
                                      torch.from_numpy(y), act))
    assert got == pytest.approx(want, rel=1e-5)


def test_distill_loss_through_the_fused_field():
    """The student run through the fused field (K3's and K4's plain
    versions here, bf16 operands) gives the plain bf16 module's loss within
    2e-2 relative, and its gradients reach every parameter."""
    from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
    from fashion_nerf_torch.models.nerf_mlp import module_field
    cfg = load_config("blender_lego", PROP[:3])
    student = proposal.init_proposal(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (256, 1, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.uniform(0.0, 1.0, 256).astype(np.float32))
    plain = proposal.distill_loss(student, pts, y)
    fused = proposal.distill_loss(student, pts, y,
                                  field=make_fused_field())
    assert float(fused) == pytest.approx(float(plain), rel=2e-2)
    grads = torch.autograd.grad(fused, list(student.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads[:-2])
    assert field_for(cfg) is not module_field
    off = load_config("blender_lego", ["kernels.use_pallas=false"])
    assert field_for(off) is field_for(off, training=True) is module_field


def test_distill_points_fill_box_and_world():
    """7/8 of the points lie in the box, the rest across the world box, at
    the same relative position, as the reference draws them."""
    g = torch.Generator().manual_seed(0)
    bmin, bmax = torch.full((3,), -0.5), torch.full((3,), 0.25)
    wmin, wmax = torch.full((3,), -2.0), torch.full((3,), 2.0)
    pts = proposal.distill_points(g, 8192, bmin, bmax, wmin, wmax)
    assert pts.shape == (8192, 1, 3)
    inside = ((pts >= bmin) & (pts <= bmax)).all(dim=-1)
    assert 0.86 < float(inside.float().mean()) < 0.90
    assert bool(((pts >= wmin) & (pts <= wmax)).all())
    assert float(pts.abs().max()) > 1.0          # the world share is there


def _blob_teacher(pts, _dirs):
    """An analytic density: a Gaussian blob at the origin, raw σ."""
    sigma = 30.0 * torch.exp(-4.0 * (pts ** 2).sum(-1)) - 0.5
    return torch.zeros(pts.shape[:-1] + (3,)), sigma


def test_distill_proposal_converges_and_is_deterministic(capsys):
    """200 steps on the blob: the log-density MSE on fresh points falls
    under 0.05, from over ten times that at initialisation; the same
    generator state gives the same net."""
    cfg = load_config("blender_lego", PROP + ["proposal.distill_lr=5e-3"])
    box = [torch.full((3,), v) for v in (-1.0, 1.0, -2.0, 2.0)]
    nets = [proposal.distill_proposal(
        cfg, _blob_teacher, torch.Generator().manual_seed(seed),
        box_min=box[0], box_max=box[1], steps=200) for seed in (0, 0, 1)]
    assert "proposal distilled in 200 steps" in capsys.readouterr().err
    pts = proposal.distill_points(torch.Generator().manual_seed(9), 2048,
                                  *box)
    y = proposal.log_density(_blob_teacher(pts, None)[1][:, 0])
    with torch.no_grad():
        last = float(proposal.distill_loss(nets[0], pts, y))
        first = float(proposal.distill_loss(proposal.init_proposal(
            cfg, torch.Generator().manual_seed(0)), pts, y))
    assert last < 0.05 and first > 10 * last
    pm = proposal.proposal_model_config(cfg)
    assert (nets[0].depth, nets[0].width, nets[0].use_viewdirs) == (
        pm.net_depth, 32, False)
    a, b, c = (torch.cat([p.detach().flatten() for p in n.parameters()])
               for n in nets)
    # the same draws; a multi-threaded BLAS may sum in another order
    torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    assert float((a - c).abs().max()) > 1e-2


@pytest.fixture(scope="module")
def flagship_fine():
    loaded = load_flagship()
    if loaded is None:
        pytest.skip("trained flagship asset missing")
    return load_flax_params(loaded[0]["fine"], compute_dtype="bfloat16")


def test_attach_proposal_distils_and_saves(flagship_fine, tmp_path, capsys):
    """use_asset=False distils from the committed fine net (3 steps here);
    `save_proposal_asset` writes it signed for those weights, and a later
    `attach_proposal` takes it from that file without distilling."""
    cfg = load_config("blender_lego", ["proposal.distill_steps=3",
                                       "proposal.distill_batch=64"])
    out = proposal.attach_proposal(cfg, {"fine": flagship_fine},
                                   use_asset=False)
    assert "proposal distilled in 3 steps" in capsys.readouterr().err
    prop = out["proposal"]
    assert (prop.depth, prop.width, prop.posenc_xyz) == (2, 128, 6)
    path = proposal.save_proposal_asset(cfg, prop, flagship_fine,
                                        str(tmp_path / "prop.npz"))
    again = proposal.attach_proposal(cfg, {"fine": flagship_fine}, path=path,
                                     allow_distill=False)
    for p, q in zip(prop.parameters(), again["proposal"].parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert capsys.readouterr().err == ""


def test_attach_proposal_noop_and_refusals(flagship_fine, tmp_path):
    cfg = load_config("blender_lego")
    params = {"fine": flagship_fine}
    off = load_config("blender_lego", ["proposal.enabled=false"])
    assert proposal.attach_proposal(off, params) is params
    missing = str(tmp_path / "none.npz")
    assert proposal.attach_proposal(cfg, params, path=missing,
                                    allow_distill=False) is params
    # a cond vector is taken (a conditioned teacher's); with no asset and
    # no distillation the params come back unchanged
    assert proposal.attach_proposal(cfg, params, cond=np.zeros(4),
                                    path=missing, allow_distill=False) \
        is params


# --- the dense path from a checkpoint ---------------------------------------

@pytest.fixture(scope="module")
def dense_run(scene, tmp_path_factory):
    """A checkpoint holding the reference's freshly initialised weights,
    and the reference's renders of them: the path of the two training
    poses and the held-out view with its scores."""
    out = tmp_path_factory.mktemp("dense")
    jcfg = j_load_config("tiny_lego", DENSE)
    cfg = load_config("tiny_lego", DENSE + [f"out_dir={out}"])
    jstate = j_create(jcfg, jax.random.PRNGKey(0))
    ckpt_lib.save(os.path.join(str(out), cfg.name, "ckpt"),
                  _port_state(cfg, jstate.params))
    field_c, field_f = jloop.make_fields(jcfg)
    fc = functools.partial(field_c, jstate.params["coarse"])
    ff = functools.partial(field_f, jstate.params["fine"])
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    frames = np.asarray(jrenderer.render_path(fc, ff, scene["poses"], H, W,
                                              focal, jcfg))
    val = jrenderer.render_image(fc, ff, H, W, focal,
                                 jnp.asarray(scene["val_pose"]), jcfg)["rgb"]
    ref = jnp.asarray(scene["val_image"])
    scores = (float(jmetrics.psnr(val, ref)), float(jmetrics.ssim(val, ref)))
    return dict(out=str(out), cfg=cfg, params=jstate.params, frames=frames,
                scores=scores)


def test_render_path_matches_reference(scene, dense_run):
    cfg = dense_run["cfg"]
    state = _port_state(cfg, dense_run["params"])
    field_c = field_f = field_for(cfg)
    with torch.no_grad():
        frames = renderer.render_path(
            lambda p, v: field_c(state.coarse, p, v),
            lambda p, v: field_f(state.fine, p, v), scene["poses"],
            scene["H"], scene["W"], scene["focal"], cfg)
    want = torch.from_numpy(dense_run["frames"])
    assert frames.shape == want.shape == (2, 16, 16, 3)
    for a, b in zip(frames, want):
        assert float(psnr(a, b)) >= 40.0
    assert float(frames.std()) > 1e-3


def test_cli_eval_matches_reference(scene, dense_run, capsys):
    """`eval` from the checkpoint: the reference's eval row keys, PSNR
    within 0.05 dB and SSIM within 1e-3 of the reference's render of the
    same weights; config.json holds the resolved config."""
    argv = ["eval", "--config", "tiny_lego", "--device", "cpu", "--out",
            dense_run["out"]] + _set(DENSE)
    assert cli.main(argv, dataset=scene) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(row) == ["n_views", "psnr", "ssim"] and row["n_views"] == 1
    assert abs(row["psnr"] - dense_run["scores"][0]) <= 0.05
    assert abs(row["ssim"] - dense_run["scores"][1]) <= 1e-3
    with open(os.path.join(dense_run["out"], "tiny_lego",
                           "config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(config_to_dict(
            dense_run["cfg"])))


def test_cli_render_matches_reference(scene, dense_run, capsys):
    """`render` writes one PNG a pose, each ≥ 40 dB against the reference's
    frame (8-bit rounding alone is ~59 dB)."""
    argv = ["render", "--config", "tiny_lego", "--device", "cpu", "--out",
            dense_run["out"]] + _set(DENSE)
    assert cli.main(argv, dataset=scene) == 0
    cap = capsys.readouterr()
    row = json.loads(cap.out.strip().splitlines()[-1])
    assert row == {"frames": 2, "out": os.path.join(
        dense_run["out"], "tiny_lego", "render")}
    assert "2 frames of 16x16 rendered" in cap.err
    pngs = sorted(f for f in os.listdir(row["out"]) if f.endswith(".png"))
    assert pngs == ["000.png", "001.png"]
    for name, want in zip(pngs, dense_run["frames"]):
        got = png.read_png(os.path.join(row["out"], name))
        assert got.shape == (16, 16, 3) and got.dtype == np.uint8
        assert float(psnr(torch.from_numpy(got / 255.0),
                          torch.from_numpy(np.clip(want, 0, 1)))) >= 40.0


def test_cli_parity_sweeps_scene_checkpoints(scene, dense_run, tmp_path,
                                             capsys):
    """`parity` over a root with one fabricated scene directory evaluates
    the checkpoint at <out>/<scene>/<config>/ckpt; a root without scenes
    gives exit code 1 and the reference's error line."""
    root = tmp_path / "root"
    (root / "lego").mkdir(parents=True)
    (root / "lego" / "transforms_train.json").write_text("{}")
    out = tmp_path / "out"
    state = _port_state(dense_run["cfg"], dense_run["params"])
    ckpt_lib.save(str(out / "lego" / "tiny_lego" / "ckpt"), state)
    ovr = DENSE + [f"data.root={root}", "data.dataset=blender"]
    argv = ["parity", "--config", "tiny_lego", "--device", "cpu", "--out",
            str(out)] + _set(ovr)
    assert cli.main(argv, dataset=scene) == 0
    rows = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    assert rows[0]["scene"] == "lego" and rows[0]["anchor_psnr"] == 32.54
    assert rows[0]["psnr"] == pytest.approx(dense_run["scores"][0], abs=0.05)
    assert rows[0]["parity"] is False and rows[1]["scenes"] == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    argv[argv.index(f"data.root={root}")] = f"data.root={empty}"
    assert cli.main(argv, dataset=scene) == 1
    assert json.loads(capsys.readouterr().err)["error"] == "no scenes found"


# --- train → eval → render, and the blockwise path ---------------------------

def test_cli_train_eval_render_tiny(tmp_path, capsys):
    """The three subcommands in a row through `cli.main` on `tiny_lego`
    (coarse-only, kernels off: the dense renderer), under tmp_path."""
    ovr = ["model.net_depth=2", "model.net_width=32", "model.posenc_xyz=2",
           "sampling.n_coarse=8", "data.root="]
    common = ["--config", "tiny_lego", "--device", "cpu", "--out",
              str(tmp_path)] + _set(ovr)
    train = ["train.batch_rays=32", "train.iters=4", "train.log_every=2",
             "train.ckpt_every=4", "train.eval_every=100"]
    assert cli.main(["train"] + common + _set(train)) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "steps"] == 4
    assert cli.main(["eval"] + common) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(row) == ["n_views", "psnr", "ssim"]
    assert np.isfinite(row["psnr"]) and 0.0 < row["ssim"] < 1.0
    assert cli.main(["render"] + common) == 0
    cap = capsys.readouterr()
    assert "ineligible" not in cap.err      # the fast path was not asked for
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["frames"] == 12               # the hermetic scene's 12 poses
    frames = [png.read_png(os.path.join(out["out"], f"{i:03d}.png"))
              for i in range(12)]
    assert all(f.shape == (64, 64, 3) for f in frames)
    assert any(f.std() > 0 for f in frames)
    assert (tmp_path / "tiny_lego" / "config.json").exists()


def test_cli_blockwise_eval_with_distilled_proposal(scene, tmp_path, capsys):
    """A small `blender_lego`: two training steps, then `eval` through the
    blockwise path (the plain versions of K3, K1 and K2 on the CPU, so no
    launch is counted) with a proposal distilled for the checkpoint, and
    `eval` with kernels.fused_mlp=false: the dense renderer, and a line on
    stderr that says so."""
    ovr = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
           "model.skips=1", "sampling.n_coarse=16", "sampling.n_fine=16",
           "occupancy.resolution=16", "occupancy.macro=4",
           "render.chunk=256", "proposal.distill_steps=5"] + PROP[:3]
    common = ["--config", "blender_lego", "--device", "cpu", "--out",
              str(tmp_path)] + _set(ovr)
    train = ["train.batch_rays=64", "train.iters=2", "train.log_every=2",
             "train.ckpt_every=2", "train.eval_every=100",
             "train.precrop_iters=0"]
    assert cli.main(["train"] + common + _set(train), dataset=scene) == 0
    capsys.readouterr()
    K.reset_launches()
    assert cli.main(["eval"] + common, dataset=scene) == 0
    cap = capsys.readouterr()
    row = json.loads(cap.out.strip().splitlines()[-1])
    assert np.isfinite(row["psnr"]) and row["n_views"] == 1
    assert "proposal distilled in 5 steps" in cap.err
    assert "ineligible" not in cap.err
    assert not any(K.LAUNCHES.values())
    assert cli.main(["eval"] + common + _set(["kernels.fused_mlp=false"]),
                    dataset=scene) == 0
    cap = capsys.readouterr()
    assert "blockwise fast path ineligible" in cap.err
    assert "distilled" not in cap.err
    assert np.isfinite(json.loads(cap.out.strip().splitlines()[-1])["psnr"])


# --- parser, refusals, PNG, checkpoints --------------------------------------

def _subparsers(parser):
    action = next(a for a in parser._actions
                  if hasattr(a, "choices") and isinstance(a.choices, dict))
    return {name: sorted(o for o in sp._option_string_actions
                         if o.startswith("--"))
            for name, sp in action.choices.items()}


def test_parser_equals_reference_plus_device():
    got, want = _subparsers(cli._parser()), _subparsers(jcli._parser())
    assert sorted(got) == sorted(want) == sorted(cli.SUBCOMMANDS)
    for name, flags in want.items():
        assert got[name] == sorted(flags + ["--device"]), name


@pytest.mark.parametrize("argv,exc,match", [
    (["preprocess", "--config", "viton_tryon"], RuntimeError,
     "no CUDA device"),
    (["render", "--config", "dynamic_tryon", "--device", "cpu"],
     FileNotFoundError, "no checkpoint"),
    (["eval", "--config", "tiny_lego"], RuntimeError, "no CUDA device"),
    (["render", "--config", "tiny_lego"], RuntimeError, "no CUDA device"),
    (["parity", "--config", "tiny_lego"], RuntimeError, "no CUDA device"),
    (["bench", "--config", "blender_lego"], RuntimeError, "CUDA"),
    (["bench", "--config", "blender_lego", "--device", "cpu"], RuntimeError,
     "CUDA")])
def test_cli_refusals(argv, exc, match, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        cli.main(argv + ["--out", str(tmp_path)])


def test_cli_eval_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cli.main(["eval", "--config", "tiny_lego", "--device", "cpu",
                  "--out", str(tmp_path)] + _set(DENSE))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, img.astype(np.float32))


def test_png_reads_with_imageio(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    path = str(tmp_path / "y.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)


def test_checkpoint_restores_across_device_kinds(dense_run, tmp_path):
    """A checkpoint whose generator state is another device kind's
    restores the nets, Adam and the step and leaves the template's
    generator as it is."""
    cfg = dense_run["cfg"]
    state = _port_state(cfg, dense_run["params"])
    state.step = 3
    d = str(tmp_path / "ckpt")
    ckpt_lib.save(d, state)
    path = os.path.join(d, "step_00000003.pt")
    payload = torch.load(path, weights_only=True)
    assert payload["generator_device"] == "cpu"
    payload["generator_device"] = "cuda"
    payload["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(payload, path)
    fresh = _port_state(cfg, jax.tree_util.tree_map(
        lambda x: np.zeros_like(x), jax.device_get(dense_run["params"])))
    before = fresh.generator.get_state().clone()
    ckpt_lib.restore(d, fresh)
    assert fresh.step == 3
    assert torch.equal(fresh.generator.get_state(), before)
    for p, q in zip(fresh.parameters(), state.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
