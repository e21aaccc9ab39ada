"""NeRF-synthetic (Blender) loader; counterpart of `fashion_nerf.data.blender`.

Layout: transforms_{train,val,test}.json with `camera_angle_x` and
per-frame `transform_matrix` (4×4 camera-to-world), RGBA PNGs. Alpha
composites onto white (or black), focal = 0.5·W / tan(0.5·camera_angle_x),
`half_res` is a 2×2 box filter, and the render path is the 40 spherical
poses of the reference. Images are read through `data/images.py`.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fashion_nerf_torch.data.images import imread
from fashion_nerf_torch.data.synthetic import _pose_spherical


def _composite(imgs, white_bkgd: bool):
    if imgs.shape[-1] == 4:
        rgb, a = imgs[..., :3], imgs[..., 3:]
        return rgb * a + (1.0 - a) if white_bkgd else rgb * a
    return imgs


def _half(imgs):
    """2×2 box-filter downsample of (N, H, W, C)."""
    H2, W2 = imgs.shape[1] // 2, imgs.shape[2] // 2
    out = imgs[:, :H2 * 2, :W2 * 2]
    out = 0.25 * (out[:, 0::2, 0::2] + out[:, 1::2, 0::2]
                  + out[:, 0::2, 1::2] + out[:, 1::2, 1::2])
    return out.astype(np.float32)


def load_blender(root: str, half_res: bool = False, white_bkgd: bool = True,
                 splits=("train", "val", "test")) -> dict:
    """→ dict(images, poses, focal, val_image, val_pose, test_images,
    test_poses, render_poses, H, W, near, far)."""
    metas, imgs, poses = {}, {}, {}
    for s in splits:
        with open(os.path.join(root, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)
        frames = metas[s]["frames"]
        im = [imread(os.path.join(root, fr["file_path"] + ".png"))
              for fr in frames]
        imgs[s] = np.stack(im) if im else np.zeros((0, 1, 1, 4))
        poses[s] = (np.stack([np.asarray(fr["transform_matrix"], np.float32)
                              for fr in frames]) if frames
                    else np.zeros((0, 4, 4), np.float32))

    H, W = imgs["train"].shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * float(metas["train"]["camera_angle_x"]))

    def split(name):
        out = _composite(imgs.get(name, imgs["train"][:1]), white_bkgd)
        return _half(out) if half_res else out

    train, val, test = split("train"), split("val"), split("test")
    if half_res:
        H, W, focal = H // 2, W // 2, focal * 0.5
    render_poses = np.stack(
        [_pose_spherical(a, -30.0, 4.0)
         for a in np.linspace(-180, 180, 40, endpoint=False)])
    return {
        "images": train.astype(np.float32),
        "poses": poses["train"][:, :3, :4],
        "focal": float(focal),
        "val_image": val[0] if len(val) else train[0],
        "val_pose": poses.get("val", poses["train"])[0][:3, :4],
        "test_images": test.astype(np.float32),
        "test_poses": poses.get("test", poses["train"])[:, :3, :4],
        "render_poses": render_poses,
        "H": H, "W": W, "near": 2.0, "far": 6.0,
    }
