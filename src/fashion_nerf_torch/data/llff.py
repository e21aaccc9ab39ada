"""LLFF forward-facing loader; counterpart of `fashion_nerf.data.llff`.

Layout: poses_bounds.npy of shape (N, 17): per image a 3×5 matrix
(rotation | translation | [H, W, focal]) in the [down, right, back]
convention and its [near, far] bounds; images in images_{factor}/, or in
images/ box-downsampled by the factor. The poses are turned to [right, up,
back], rescaled so the nearest bound sits at 1 / bd_factor, recentred on
their average, and every `holdout`-th image is held out for test. The
render path is a 40-view spiral; rays are sampled in NDC (near 0, far 1).
Images are read through `data/images.py`.
"""

from __future__ import annotations

import os

import numpy as np

from fashion_nerf_torch.data.images import imread


def _box_down(img: np.ndarray, factor: int) -> np.ndarray:
    H2, W2 = img.shape[0] // factor, img.shape[1] // factor
    img = img[:H2 * factor, :W2 * factor]
    img = img.reshape(H2, factor, W2, factor, -1).mean(axis=(1, 3))
    return img.astype(np.float32)


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _poses_avg(poses):
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _viewmatrix(vec2, up, center)


def recenter_poses(poses):
    """Rigidly transform all poses so that their average is the identity."""
    c2w = _poses_avg(poses)
    bottom = np.array([[0, 0, 0, 1.0]], np.float32)
    c2w_h = np.concatenate([c2w, bottom], 0)
    poses_h = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (len(poses), 1, 1))], 1)
    return (np.linalg.inv(c2w_h) @ poses_h)[:, :3, :4].astype(np.float32)


def spiral_path(poses, bounds, n_views: int = 120, n_rots: int = 2,
                zrate: float = 0.5):
    """The LLFF spiral render path around the average pose."""
    c2w = _poses_avg(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(poses[:, :3, 3] - c2w[:3, 3]), 90, axis=0)
    rads = np.concatenate([rads, [1.0]])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views,
                             endpoint=False):
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(_viewmatrix(z, up, c).astype(np.float32))
    return np.stack(out)


def load_llff(root: str, factor: int = 8, recenter: bool = True,
              bd_factor: float = 0.75, spherify: bool = False,
              holdout: int = 8) -> dict:
    """→ the dataset dict of `blender.load_blender`, with NDC bounds and the
    rescaled per-image `bounds`. `spherify` is accepted and ignored, as the
    reference ignores it."""
    pb = np.load(os.path.join(root, "poses_bounds.npy"))
    poses = pb[:, :-2].reshape(-1, 3, 5)
    bounds = pb[:, -2:]

    img_dir = os.path.join(root, f"images_{factor}" if factor > 1
                           else "images")
    need_down = 1
    if not os.path.isdir(img_dir):
        img_dir = os.path.join(root, "images")
        need_down = factor
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    imgs = []
    for f in files:
        img = imread(os.path.join(img_dir, f))[..., :3]
        imgs.append(_box_down(img, need_down) if need_down > 1 else img)
    images = np.stack(imgs)
    if len(images) != len(poses):
        raise ValueError(f"{root}: {len(images)} images for {len(poses)} "
                         "poses")

    H, W = images.shape[1:3]
    focal = float(poses[0, 2, 4]) * H / poses[0, 0, 4]
    # [down, right, back] → [right, up, back]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4]], axis=2)
    scale = 1.0 / (bounds.min() * bd_factor)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale
    if recenter:
        poses = recenter_poses(poses)
    render_poses = spiral_path(poses, bounds, n_views=40)

    i_test = np.arange(len(images))[::holdout]
    i_train = np.array([i for i in range(len(images)) if i not in i_test])
    return {
        "images": images[i_train],
        "poses": poses[i_train, :3, :4].astype(np.float32),
        "focal": focal,
        "val_image": images[i_test[0]],
        "val_pose": poses[i_test[0], :3, :4].astype(np.float32),
        "test_images": images[i_test],
        "test_poses": poses[i_test, :3, :4].astype(np.float32),
        "render_poses": render_poses,
        "H": H, "W": W, "near": 0.0, "far": 1.0,
        "bounds": bounds,
    }
