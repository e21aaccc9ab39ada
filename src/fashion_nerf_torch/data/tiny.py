"""Tiny-NeRF dataset; counterpart of `fashion_nerf.data.tiny`.

Loads the canonical tiny_nerf_data.npz layout (images (N,H,W,3) f32,
poses (N,4,4), focal scalar) when a path is given; with no path, the
hermetic procedural scene.
"""

from __future__ import annotations

import os

import numpy as np

from fashion_nerf_torch.data.synthetic import make_synthetic_scene


def load_tiny(path: str = "", n_views: int = 12, H: int = 64, W: int = 64):
    """→ dict(images, poses (N,3,4), focal, val_image, val_pose, near, far)."""
    if path and os.path.exists(path):
        d = np.load(path)
        images = d["images"].astype(np.float32)
        poses = d["poses"].astype(np.float32)[:, :3, :4]
        focal = float(d["focal"])
        # the last view is held out for validation
        return {
            "images": images[:-1], "poses": poses[:-1], "focal": focal,
            "val_image": images[-1], "val_pose": poses[-1],
            "near": 2.0, "far": 6.0,
            "H": images.shape[1], "W": images.shape[2],
        }
    return make_synthetic_scene(n_views=n_views, H=H, W=W)
