"""OpenPose keypoints → rasterised conditioning maps; counterpart of
`fashion_nerf.tryon.pose`."""

from __future__ import annotations

import numpy as np
import torch

# OpenPose BODY_18 limb pairs
LIMBS_18 = (
    (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7),
    (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
    (0, 14), (14, 16), (0, 15), (15, 17),
)


def _kpts(kpts, device):
    return torch.as_tensor(kpts, dtype=torch.float32, device=device)


def rasterize_keypoints(kpts, H: int, W: int, sigma: float = 3.0,
                        device=None):
    """kpts (J, 3) of (x, y, confidence) in pixels → (H, W, J) Gaussian
    heatmaps; joints of confidence 0 give zero maps."""
    kpts = _kpts(kpts, device)
    dev = kpts.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    dx = xs - kpts[None, None, :, 0]
    dy = ys - kpts[None, None, :, 1]
    heat = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return heat * (kpts[:, 2] > 0).float()[None, None, :]


def limb_maps(kpts, H: int, W: int, limbs=LIMBS_18, width: float = 4.0,
              device=None):
    """(H, W, len(limbs)) stick maps: 1 within `width` px of each limb
    segment whose two endpoints are confident."""
    kpts = _kpts(kpts, device)
    dev = kpts.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    maps = []
    for a, b in limbs:
        pa, pb = kpts[a], kpts[b]
        ok = ((pa[2] > 0) & (pb[2] > 0)).float()
        d = pb[:2] - pa[:2]
        len2 = torch.clamp(torch.sum(d * d), min=1e-8)
        t = torch.clamp(((xs - pa[0]) * d[0] + (ys - pa[1]) * d[1]) / len2,
                        0.0, 1.0)
        dist2 = (xs - (pa[0] + t * d[0])) ** 2 + (ys - (pa[1] + t * d[1])) ** 2
        maps.append((dist2 <= width * width).float() * ok)
    return torch.stack(maps, dim=-1)


def load_openpose_json(obj) -> np.ndarray:
    """An OpenPose JSON dict (or its people list) → (J, 3) f32 array of the
    first person's body keypoints; 18 zero rows when nobody is found."""
    people = obj.get("people", []) if isinstance(obj, dict) else obj
    if not people:
        return np.zeros((18, 3), np.float32)
    return np.asarray(people[0]["pose_keypoints_2d"],
                      np.float32).reshape(-1, 3)
