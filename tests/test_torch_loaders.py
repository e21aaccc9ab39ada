"""The port's blender and LLFF loaders (fashion_nerf_torch.data.blender,
.llff) against the JAX package's, on the same temporary fixtures: the
layouts of tests/unit/test_loaders.py, written as PNGs by the port's
writer (`png.write_png`). Images, poses, focal, bounds and render poses
agree to 1e-6 (the same float32 numpy arithmetic on both sides; the
decoders differ, so the pixels must come out equal). Also: `half_res`,
`images_{factor}` against the box-down of `images/`, the holdout split,
`spherify` ignored as the reference ignores it, a JPEG without a decoder
raising an error that names the file, and `load_dataset` routing
`data.root` to the loaders."""

import json
import os
import sys

import numpy as np
import pytest

from fashion_nerf.data.blender import load_blender as j_blender
from fashion_nerf.data.llff import load_llff as j_llff
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch.data import blender, llff
from fashion_nerf_torch.data.images import imread
from fashion_nerf_torch.data.synthetic import _pose_spherical
from fashion_nerf_torch.png import write_png
from fashion_nerf_torch.train.loop import load_dataset

TOL = 1e-6


def _png(path, img):
    write_png(str(path), (np.clip(img, 0, 1) * 255).astype(np.uint8))


def write_blender(root, H=8, W=8, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        frames = []
        os.makedirs(root / split, exist_ok=True)
        for i in range(n):
            pose = _pose_spherical(120.0 * i, -30.0, 4.0)
            pose4 = np.concatenate(
                [pose, np.array([[0, 0, 0, 1.0]], np.float32)], 0)
            _png(root / split / f"r_{i}.png", rng.uniform(size=(H, W, 4)))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose4.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return str(root)


def write_llff(root, H=12, W=16, n=6, focal=20.0, seed=1, factor_dir=None):
    """An LLFF scene of n images in the poses_bounds.npy layout: cameras in
    [down, right, back] spread along x and y, looking down −z. With
    factor_dir=f, also images_f/ holding the images box-downsampled."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "images", exist_ok=True)
    rows = []
    for i in range(n):
        img = rng.uniform(size=(H, W, 3))
        _png(root / "images" / f"{i:03d}.png", img)
        if factor_dir:
            os.makedirs(root / f"images_{factor_dir}", exist_ok=True)
            _png(root / f"images_{factor_dir}" / f"{i:03d}.png",
                 llff._box_down(img.astype(np.float32), factor_dir))
        c2w = np.zeros((3, 5), np.float32)
        c2w[:, 0] = [0, -1, 0]
        c2w[:, 1] = [1, 0, 0]
        c2w[:, 2] = [0, 0, 1]
        c2w[:, 3] = [0.1 * i, 0.02 * i, 0.0]
        c2w[:, 4] = [H, W, focal]
        rows.append(np.concatenate([c2w.reshape(-1), [2.0 + 0.1 * i,
                                                      10.0]]))
    np.save(root / "poses_bounds.npy", np.stack(rows))
    return str(root)


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL,
                                       err_msg=k)
        else:
            assert got[k] == pytest.approx(v, rel=TOL, abs=TOL), k


@pytest.mark.parametrize("half_res,white", [(False, True), (True, True),
                                            (False, False)])
def test_blender_matches_reference(tmp_path, half_res, white):
    root = write_blender(tmp_path)
    got = blender.load_blender(root, half_res=half_res, white_bkgd=white)
    _same(got, j_blender(root, half_res=half_res, white_bkgd=white))
    side = 4 if half_res else 8
    assert got["images"].shape == (3, side, side, 3)
    assert got["H"] == got["W"] == side
    assert got["render_poses"].shape == (40, 3, 4)


@pytest.mark.parametrize("factor,holdout", [(1, 3), (2, 3), (1, 8)])
def test_llff_matches_reference(tmp_path, factor, holdout):
    root = write_llff(tmp_path)
    got = llff.load_llff(root, factor=factor, holdout=holdout)
    _same(got, j_llff(root, factor=factor, holdout=holdout))
    n_test = len(range(0, 6, holdout))
    assert len(got["test_images"]) == n_test
    assert len(got["images"]) == 6 - n_test
    assert got["images"].shape[1:] == (12 // factor, 16 // factor, 3)
    assert got["near"] == 0.0 and got["far"] == 1.0
    assert got["bounds"].min() == pytest.approx(1.0 / 0.75, rel=1e-6)


def test_llff_prefers_images_factor_dir(tmp_path):
    """images_2/ is read as it is; without it images/ is box-downsampled:
    equal up to the 8-bit rounding of the stored images_2 (1/255), and
    each the reference's on the same tree."""
    with_dir = write_llff(tmp_path / "a", factor_dir=2)
    plain = write_llff(tmp_path / "b")
    a = llff.load_llff(with_dir, factor=2)
    b = llff.load_llff(plain, factor=2)
    _same(a, j_llff(with_dir, factor=2))
    _same(b, j_llff(plain, factor=2))
    np.testing.assert_allclose(a["images"], b["images"], atol=1.0 / 255)
    assert a["focal"] == b["focal"]


def test_llff_spherify_is_ignored(tmp_path):
    """The reference accepts `spherify` and never reads it; so does the
    port: the same dict either way."""
    root = write_llff(tmp_path)
    _same(llff.load_llff(root, factor=1, spherify=True),
          llff.load_llff(root, factor=1, spherify=False))


def test_pose_helpers_match_reference():
    from fashion_nerf.data import llff as jl
    rng = np.random.default_rng(3)
    poses = np.concatenate([np.tile(np.eye(3, 4, dtype=np.float32),
                                    (5, 1, 1))
                            + 0.05 * rng.normal(size=(5, 3, 4)).astype(
                                np.float32)], 0)
    bounds = rng.uniform(1.0, 8.0, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(llff.recenter_poses(poses),
                               jl.recenter_poses(poses), atol=TOL)
    np.testing.assert_allclose(llff.spiral_path(poses, bounds, 7),
                               jl.spiral_path(poses, bounds, 7), atol=TOL)
    img = rng.uniform(size=(9, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(llff._box_down(img, 3),
                                  jl._box_down(img, 3))


def test_jpeg_without_decoder_names_the_file(tmp_path, monkeypatch):
    """Only PNGs have a decoder of the port's own; a JPEG needs PIL or
    imageio and, when neither imports, raises naming the file."""
    path = tmp_path / "x.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    for mod in ("PIL", "PIL.Image", "imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(RuntimeError, match="x.jpg.*PIL or imageio"):
        imread(str(path))


def test_load_dataset_routes_roots(tmp_path):
    """data.root of a blender or llff config goes to the loaders (with
    data.half_res, render.white_bkgd, data.llff_factor); an empty root
    keeps the hermetic scenes; a missing root raises naming the file."""
    root_b = write_blender(tmp_path / "lego")
    d = load_dataset(load_config("blender_lego", [f"data.root={root_b}",
                                                  "data.half_res=true"]))
    _same(d, j_blender(root_b, half_res=True, white_bkgd=True))
    root_l = write_llff(tmp_path / "fern", H=16, W=24)
    d = load_dataset(load_config("llff_fern", [f"data.root={root_l}",
                                               "data.llff_factor=2"]))
    _same(d, j_llff(root_l, factor=2))
    assert load_dataset(load_config("llff_fern"))["images"].shape == (
        12, 96, 128, 3)
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        load_dataset(load_config("blender_lego",
                                 [f"data.root={tmp_path / 'none'}"]))
