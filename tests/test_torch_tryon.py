"""The port's try-on preprocessing (fashion_nerf_torch.tryon, data.viton,
models.conditioned) and the try-on command line against the JAX reference
on the CPU: masks, morphology, the agnostic image, keypoint rasters,
resize, the TPS solve and grid sample, the flow warp, the procedural pair,
the matcher and the garment encoder with carried weights, the pipeline's
conditioning stack, the VITON loader, `preprocess`, and `eval` / `render`
of small conditioned checkpoints (with the pinned dynamic try-on caveat:
every frame shares the latent-0 occupancy grid and proposal)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashion_nerf.config import load_config as j_load_config
from fashion_nerf.data import viton as jv
from fashion_nerf.models.conditioned import GarmentEncoder as JEncoder
from fashion_nerf.tryon import flow as jflow
from fashion_nerf.tryon import matcher as jm
from fashion_nerf.tryon import pipeline as jp
from fashion_nerf.tryon import pose as jpose
from fashion_nerf.tryon import segmentation as jseg
from fashion_nerf.tryon import tps as jtps
from fashion_nerf_torch import cli, png
from fashion_nerf_torch import ckpt as ckpt_lib
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.data import viton as tv
from fashion_nerf_torch.models.conditioned import GarmentEncoder
from fashion_nerf_torch.tryon import flow as tflow
from fashion_nerf_torch.tryon import matcher as tm
from fashion_nerf_torch.tryon import pipeline as tp
from fashion_nerf_torch.tryon import pose as tpose
from fashion_nerf_torch.tryon import segmentation as tseg
from fashion_nerf_torch.tryon import tps as ttps
from fashion_nerf_torch.train.state import state_from_params

torch.set_num_threads(2)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _parse(rng, H=24, W=20):
    return rng.choice([0, 2, 5, 6, 7, 9, 13, 14], size=(H, W)).astype(
        np.int32)


# --------------------------------------------------------------------------
# segmentation, pose, resize
# --------------------------------------------------------------------------

def test_masks_exact_and_morphology():
    rng = np.random.default_rng(0)
    parse = _parse(rng)
    mj, mt = jseg.parse_to_masks(jnp.asarray(parse)), \
        tseg.parse_to_masks(_t(parse))
    assert set(mj) == set(mt)
    for k in mj:
        np.testing.assert_array_equal(_np(mt[k]), _np(mj[k]), err_msg=k)
    g = mj["garment"]
    for r in (1, 2, 3):
        np.testing.assert_allclose(_np(tseg.dilate(_t(g), r)),
                                   _np(jseg.dilate(g, r)), atol=1e-5)
        np.testing.assert_allclose(_np(tseg.erode(_t(g), r)),
                                   _np(jseg.erode(g, r)), atol=1e-5)
    img = rng.random((24, 20, 3)).astype(np.float32)
    aj, _ = jseg.make_agnostic(jnp.asarray(img), jnp.asarray(parse))
    at, _ = tseg.make_agnostic(_t(img), _t(parse))
    np.testing.assert_allclose(_np(at), _np(aj), atol=1e-5)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resize_downscale_matches_jax_image(method):
    """96×72 → 64×48: the antialiased triangle kernel of jax.image.resize
    (not F.interpolate's), and nearest at half-pixel centres."""
    img = np.random.default_rng(1).random((96, 72, 3)).astype(np.float32)
    want = jseg.resize_image(jnp.asarray(img), 64, 48, method)
    got = tseg.resize_image(_t(img), 64, 48, method)
    assert got.shape == (64, 48, 3)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_keypoint_maps():
    rng = np.random.default_rng(2)
    kp = np.concatenate([rng.uniform(0, 30, (18, 2)),
                         (rng.random((18, 1)) > 0.3)], 1).astype(np.float32)
    np.testing.assert_allclose(_np(tpose.rasterize_keypoints(kp, 32, 28, 3.0)),
                               _np(jpose.rasterize_keypoints(kp, 32, 28, 3.0)),
                               atol=1e-5)
    np.testing.assert_allclose(_np(tpose.limb_maps(kp, 32, 28)),
                               _np(jpose.limb_maps(kp, 32, 28)), atol=1e-5)
    obj = {"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}
    np.testing.assert_array_equal(tpose.load_openpose_json(obj),
                                  jpose.load_openpose_json(obj))
    assert tpose.load_openpose_json({"people": []}).shape == (18, 3)


# --------------------------------------------------------------------------
# TPS, grid sample, flow
# --------------------------------------------------------------------------

def test_fit_tps_and_grid():
    rng = np.random.default_rng(3)
    src = rng.uniform(-0.9, 0.9, (18, 2)).astype(np.float32)
    dst = (src + rng.normal(0, 0.05, src.shape)).astype(np.float32)
    pj, pt = jtps.fit_tps(jnp.asarray(src), jnp.asarray(dst)), \
        ttps.fit_tps(_t(src), _t(dst))
    for k in ("w", "a"):
        np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), atol=1e-4)
    np.testing.assert_allclose(_np(ttps.tps_grid(pt, 24, 20)),
                               _np(jtps.tps_grid(pj, 24, 20)), atol=1e-4)


@pytest.mark.parametrize("pad", [0.0, 1.0])
def test_grid_sample_out_of_bounds(pad):
    """(x, y) in and out of [-1, 1]: every out-of-range corner tap reads the
    padding value, as the reference's gather does."""
    rng = np.random.default_rng(4)
    img = rng.random((12, 10, 3)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (16, 14, 2)).astype(np.float32)
    grid[0, 0] = [1.0, 1.0]
    grid[0, 1] = [-1.0, -1.0]
    want = jtps.grid_sample(jnp.asarray(img), jnp.asarray(grid), pad)
    got = ttps.grid_sample(_t(img), _t(grid), pad)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    assert (np.abs(grid) > 1).any(-1).any()


@pytest.mark.parametrize("normalized", [True, False])
def test_flow_warp(normalized):
    rng = np.random.default_rng(5)
    img = rng.random((16, 12, 3)).astype(np.float32)
    flow = rng.normal(0, 0.2 if normalized else 2.0, (16, 12, 2)).astype(
        np.float32)
    want = jflow.flow_warp(jnp.asarray(img), jnp.asarray(flow), 1.0,
                           normalized)
    got = tflow.flow_warp(_t(img), _t(flow), 1.0, normalized)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


# --------------------------------------------------------------------------
# the pair, the nets, the pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2_000_000])
def test_synth_viton_pair_bitwise(seed):
    a, b = jv.synth_viton_pair(64, 64, seed), tv.synth_viton_pair(64, 64,
                                                                 seed)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("hw", [(64, 64), (33, 27)])
def test_encoder_and_matcher_carried_weights(hw):
    """flax's stride-2 "SAME" pads (0, 1) on an even side and (1, 1) on an
    odd one; HWIO kernels carried into OIHW: 1e-5."""
    H, W = hw
    rng = np.random.default_rng(6)
    x = rng.random((1, H, W, 7)).astype(np.float32)
    enc = JEncoder(out_dim=64)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    got = GarmentEncoder(64).load_flax(jax.device_get(params))(_t(x))
    np.testing.assert_allclose(_np(got), _np(enc.apply(params,
                                                       jnp.asarray(x))),
                               atol=1e-5)
    person = rng.random((H, W, 5)).astype(np.float32)
    cloth = rng.random((H, W, 4)).astype(np.float32)
    mp = jm.load_matcher()
    want = jm.GarmentMatcher().apply(mp, jnp.asarray(person),
                                     jnp.asarray(cloth))
    with torch.no_grad():
        got = tm.load_matcher()(_t(person), _t(cloth))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("with_matcher", [False, True])
def test_preprocess_cond_stack(with_matcher):
    """_preprocess_device on a randomised pair: the (H, W, 7) conditioning
    stack and its parts at 1e-4, with the committed matcher and without."""
    pair = jv.synth_viton_pair(64, 64, seed=17)
    args = [jnp.asarray(pair[k]) for k in tp.PAIR_KEYS]
    oj = jp._preprocess_device(*args, H=64, W=64, matcher_params=(
        jm.load_matcher() if with_matcher else None))
    with torch.no_grad():
        ot = tp._preprocess_device(*tp.to_device(pair), H=64, W=64,
                                   matcher=(tm.load_matcher()
                                            if with_matcher else None))
    assert set(oj) == set(ot)
    for k in oj:
        np.testing.assert_allclose(_np(ot[k]), _np(oj[k]), atol=1e-4,
                                   err_msg=k)
    assert ot["cond"].shape == (64, 64, 7)


def test_correspondences_and_control_points():
    pair = jv.synth_viton_pair(64, 64, seed=3)
    pre = jp._preprocess_device(*[jnp.asarray(pair[k]) for k in tp.PAIR_KEYS],
                                H=64, W=64)
    cm = pair["cloth_mask"]
    gm = np.asarray(pre["garment_mask"])
    for a, b in zip(tp.keypoint_grid_correspondences(
                        _t(cm), _t(gm), pair["keypoints"], 64, 64),
                    jp.keypoint_grid_correspondences(
                        jnp.asarray(cm), jnp.asarray(gm), pair["keypoints"],
                        64, 64)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    np.testing.assert_allclose(_np(tp.garment_control_points(_t(cm))),
                               _np(jp.garment_control_points(
                                   jnp.asarray(cm))), atol=1e-5)
    np.testing.assert_allclose(_np(tp.torso_targets(pair["keypoints"], 64,
                                                    64)),
                               _np(jp.torso_targets(pair["keypoints"], 64,
                                                    64)), atol=1e-5)


def test_matcher_iou_matches_reference():
    """eval_iou over two held-out seeds: the same scores as the
    reference's (binarised masks, 1e-6)."""
    seeds = [2_000_000, 2_000_001]
    want = jm.eval_iou(jm.load_matcher(), jm.GarmentMatcher(), seeds)
    got = tm.eval_iou(tm.load_matcher(), seeds)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] > got[1]


# --------------------------------------------------------------------------
# PNG reading, the VITON loader, preprocess
# --------------------------------------------------------------------------

def test_read_png_grey_rgba_and_filters(tmp_path):
    """PNGs written by imageio (PIL: filtered rows) in greyscale, RGB and
    RGBA read back exactly; a greyscale write round-trips."""
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(8)
    for shape in ((20, 17), (20, 17, 3), (20, 17, 4)):
        smooth = np.cumsum(rng.integers(0, 6, shape), axis=1) % 256
        img = smooth.astype(np.uint8)
        path = str(tmp_path / f"x{len(shape)}.png")
        imageio.imwrite(path, img)
        np.testing.assert_array_equal(png.read_png(path), img)
    grey = rng.integers(0, 256, (9, 5), dtype=np.uint8)
    png.write_png(str(tmp_path / "g.png"), grey)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "g.png")),
                                  grey)


def _viton_dir(root, ids=("p0", "p1")):
    """A VITON-HD-style directory of procedural pairs, PNGs written by the
    port (RGB images, greyscale masks and parse maps) and OpenPose JSON."""
    for sub in ("image", "cloth", "cloth-mask", "image-parse",
                "openpose-json"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, pid in enumerate(ids):
        pair = tv.synth_viton_pair(48, 40, seed=i + 1)
        u8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)
        png.write_png(os.path.join(root, "image", pid + ".png"),
                      u8(pair["image"]))
        png.write_png(os.path.join(root, "cloth", pid + ".png"),
                      u8(pair["cloth"]))
        png.write_png(os.path.join(root, "cloth-mask", pid + ".png"),
                      u8(pair["cloth_mask"]))
        png.write_png(os.path.join(root, "image-parse", pid + ".png"),
                      pair["parse"].astype(np.uint8))
        with open(os.path.join(root, "openpose-json",
                               pid + "_keypoints.json"), "w") as f:
            json.dump({"people": [{"pose_keypoints_2d":
                                   pair["keypoints"].reshape(-1).tolist()}]},
                      f)


def test_load_viton_pair_from_pngs(tmp_path):
    pytest.importorskip("imageio")
    root = str(tmp_path / "viton")
    _viton_dir(root)
    a, b = jv.load_viton_pair(root, "p1"), tv.load_viton_pair(root, "p1")
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
    assert b["parse"].max() == 13 and b["image"].shape == (48, 40, 3)
    with pytest.raises(FileNotFoundError):
        tv.load_viton_pair(root, "missing")


def test_cli_preprocess_matches_reference(tmp_path, capsys):
    """`preprocess` over a two-pair directory: the same files as the
    reference's preprocess_cli, the cond .npy at 1e-4 and the PNGs within
    one 8-bit level."""
    pytest.importorskip("imageio")
    root = str(tmp_path / "viton")
    _viton_dir(root)
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    cfg_j = j_load_config("viton_tryon", [f"data.root={root}"])
    import dataclasses
    jp.preprocess_cli(dataclasses.replace(cfg_j, out_dir=out_j), None)
    assert cli.main(["preprocess", "--config", "viton_tryon", "--device",
                     "cpu", "--out", out_t, "--set", f"data.root={root}"]) \
        == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pairs"] == 2 and line["matcher"] is True
    dj = os.path.join(out_j, "viton_tryon", "preprocess")
    dt = os.path.join(out_t, "viton_tryon", "preprocess")
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for name in os.listdir(dj):
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(dt, name)),
                                       np.load(os.path.join(dj, name)),
                                       atol=1e-4)
        else:
            import imageio.v2 as imageio
            a = png.read_png(os.path.join(dt, name)).astype(int)
            b = np.asarray(imageio.imread(os.path.join(dj, name))).astype(int)
            assert np.abs(a - b).max() <= 1, name


# --------------------------------------------------------------------------
# eval and render of conditioned checkpoints
# --------------------------------------------------------------------------

SMALL = ["model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
         "model.condition_dim=16", "model.latent_dim=8",
         "occupancy.resolution=16", "proposal.distill_steps=2",
         "proposal.distill_batch=64", "sampling.n_coarse=16",
         "sampling.n_fine=16", "render.eval_n_coarse=16",
         "render.eval_n_fine=32"]


def _small_ckpt(preset, out, extra=()):
    """A checkpoint of the reference's own init of the preset, shrunk,
    saved through the port's ckpt."""
    from fashion_nerf.train.state import create_train_state
    ovr = SMALL + (["model.n_latents=4"] if preset == "dynamic_tryon"
                   else []) + list(extra)
    cfg = load_config(preset, ovr)
    params = jax.device_get(create_train_state(
        j_load_config(preset, ovr), jax.random.PRNGKey(1)).params)
    state = state_from_params(cfg, params, torch.Generator())
    ckpt_lib.save(os.path.join(out, preset, "ckpt"), state)
    return ovr


def _argv(cmd, preset, out, ovr):
    argv = [cmd, "--config", preset, "--device", "cpu", "--out", out]
    for kv in ovr:
        argv += ["--set", kv]
    return argv


@pytest.fixture(scope="module")
def viton_scene():
    return tv.load_viton_scene("", n_views=4, H=32, W=32,
                               cfg=load_config("viton_tryon"))


@pytest.mark.parametrize("pallas", ["true", "false"])
def test_cli_eval_conditioned(tmp_path, capsys, viton_scene, pallas):
    """`eval` of a viton_tryon checkpoint on the CPU through the blockwise
    path (the kernels' plain versions, a cond-aware grid, a proposal
    distilled with the cond teacher) and through the dense renderer: one
    JSON line each, finite PSNRs."""
    out = str(tmp_path)
    ovr = _small_ckpt("viton_tryon", out, [f"kernels.use_pallas={pallas}"])
    assert cli.main(_argv("eval", "viton_tryon", out, ovr),
                    dataset=viton_scene) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["n_views"] == 1 and np.isfinite(row["psnr"])


def test_cli_render_dynamic_shares_latent0_grid(tmp_path, capsys,
                                                monkeypatch):
    """Pinned reference caveat (cli.py:193-212): a dynamic render sweeps
    one occupancy grid and attaches one proposal, both at frame 0's cond
    (latent 0), and frame i takes latent i % n_latents; frames differ by
    latent."""
    out = str(tmp_path)
    ovr = _small_ckpt("dynamic_tryon", out)
    scene = tv.load_viton_scene("", n_views=5, H=16, W=16)
    scene.pop("garment")                 # the hermetic dynamic dataset
    seen = {"occ": [], "prop": [], "frames": []}
    occ0, prop0 = cli._maybe_occ, cli._with_proposal
    monkeypatch.setattr(cli, "_maybe_occ", lambda cfg, f, n, d, c=None: (
        seen["occ"].append(c), occ0(cfg, f, n, d, c))[1])
    monkeypatch.setattr(cli, "_with_proposal", lambda cfg, p, o, d, c=None: (
        seen["prop"].append(c), prop0(cfg, p, o, d, c))[1])
    from fashion_nerf_torch.train import loop as tloop
    ev0 = tloop._eval_cond
    monkeypatch.setattr(tloop, "_eval_cond", lambda *a, frame_id=0: (
        seen["frames"].append(frame_id), ev0(*a, frame_id=frame_id))[1])
    assert cli.main(_argv("render", "dynamic_tryon", out, ovr),
                    dataset=scene) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 5
    assert len(seen["occ"]) == 1 and len(seen["prop"]) == 1
    c0 = seen["occ"][0]
    assert torch.equal(seen["prop"][0], c0) and c0.shape == (24,)
    assert seen["frames"] == [0, 0, 1, 2, 3, 0]
    frames = [png.read_png(os.path.join(res["out"], f"{i:03d}.png"))
              for i in range(5)]
    assert all(f.shape == (16, 16, 3) for f in frames)
