"""VITON-HD-style paired dataset; counterpart of `fashion_nerf.data.viton`.

Layout: root/{image, cloth, cloth-mask, image-parse, openpose-json} with
matching basenames. `load_viton_pair` reads one pair through
`data/images.py` (PNGs through the port's own reader, JPEGs only where PIL
or imageio imports). `load_viton_scene` builds the garment-conditioned
NeRF dataset: multi-view images of the person and one conditioning stack shared by every
view; without a root, a procedural scene and the procedural pair.
`synth_viton_pair` is the reference's numpy generator, bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fashion_nerf_torch.data.images import imread as _imread


def _find(root: str, sub: str, stem: str, exts=(".jpg", ".png", ".jpeg")):
    for e in exts:
        p = os.path.join(root, sub, stem + e)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{sub}/{stem}.* under {root}")


def load_viton_pair(root: str, pair_id: str) -> dict:
    """→ dict(image, cloth, cloth_mask, parse, keypoints) of numpy arrays."""
    from fashion_nerf_torch.tryon.pose import load_openpose_json

    image = _imread(_find(root, "image", pair_id))[..., :3]
    cloth = _imread(_find(root, "cloth", pair_id))[..., :3]
    cm = _imread(_find(root, "cloth-mask", pair_id))
    cloth_mask = cm if cm.ndim == 2 else cm[..., 0]
    parse_img = _imread(_find(root, "image-parse", pair_id, exts=(".png",)))
    # a greyscale parse map holds the label as its value
    parse = (np.asarray(parse_img * 255.0, np.int32) if parse_img.ndim == 2
             else np.asarray(parse_img[..., 0] * 255.0, np.int32))
    kp_path = os.path.join(root, "openpose-json",
                           pair_id + "_keypoints.json")
    if os.path.exists(kp_path):
        with open(kp_path) as f:
            keypoints = load_openpose_json(json.load(f))
    else:
        keypoints = np.zeros((18, 3), np.float32)
    return {"image": image, "cloth": cloth, "cloth_mask": cloth_mask,
            "parse": parse, "keypoints": keypoints}


def load_viton_scene(root: str, pair_id: str = "", n_views: int = 12,
                     H: int = 64, W: int = 64, cfg=None, device=None) -> dict:
    """The garment-conditioned NeRF dataset: the procedural multi-view
    scene, with "garment" the (H, W, 7) conditioning stack (numpy) of the
    pair under root (the first, or `pair_id`) or of the procedural pair,
    built on `device`, and "pair" the pair itself."""
    from fashion_nerf_torch.data.synthetic import make_synthetic_scene
    from fashion_nerf_torch.tryon.pipeline import build_conditioning

    scene = make_synthetic_scene(n_views=n_views, H=H, W=W)
    if root and os.path.isdir(os.path.join(root, "image")):
        ids = sorted(os.path.splitext(f)[0]
                     for f in os.listdir(os.path.join(root, "image")))
        pair = load_viton_pair(root, pair_id or ids[0])
    else:
        pair = synth_viton_pair(H, W)
    cond = build_conditioning(pair, H, W, cfg=cfg, device=device)
    scene["garment"] = cond.cpu().numpy().astype(np.float32)
    scene["pair"] = pair
    return scene


def synth_viton_pair(H: int = 64, W: int = 64, seed: int = 0) -> dict:
    """Procedural VITON-style pair: seed 0 is the fixed pair, any other
    seed draws the torso position, extent and taper, the garment split and
    the cloth rectangle (the distribution the matcher trained on)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if seed == 0:
        cx, cy = W / 2, H / 2
        rx, ry = W * 0.25, H * 0.4
        taper = 0.0
        g_frac = 0.5
        c_x0, c_x1 = W * 0.2, W * 0.8
        c_y0, c_y1 = H * 0.3, H * 0.7
    else:
        cx = W * (0.5 + rng.uniform(-0.08, 0.08))
        cy = H * (0.5 + rng.uniform(-0.06, 0.06))
        rx = W * rng.uniform(0.18, 0.3)
        ry = H * rng.uniform(0.32, 0.44)
        taper = rng.uniform(-0.35, 0.35)
        g_frac = rng.uniform(0.4, 0.6)
        c_x0 = W * rng.uniform(0.12, 0.3)
        c_x1 = W * rng.uniform(0.65, 0.9)
        c_y0 = H * rng.uniform(0.2, 0.38)
        c_y1 = H * rng.uniform(0.6, 0.82)
    # a torso-like ellipse with a linear width taper down the body
    ynorm = np.clip((yy - (cy - ry)) / (2 * ry), 0.0, 1.0)
    rx_row = rx * (1.0 + taper * (ynorm - 0.5))
    person = (((xx - cx) / np.maximum(rx_row, 1e-3)) ** 2
              + ((yy - cy) / ry) ** 2) < 1.0
    y_split = cy - ry + 2 * ry * g_frac
    parse = np.zeros((H, W), np.int32)
    parse[person] = 9
    upper = person & (yy < y_split)
    parse[upper] = 5
    head = person & (yy < cy - ry * 0.75)
    parse[head] = 13
    image = np.full((H, W, 3), 0.9, np.float32)
    image[person] = [0.6, 0.45, 0.35]
    image[upper] = [0.2, 0.3, 0.8]
    # the flat-lay cloth: a striped rectangle
    cloth = np.full((H, W, 3), 1.0, np.float32)
    rect = (xx > c_x0) & (xx < c_x1) & (yy > c_y0) & (yy < c_y1)
    stripes = ((xx // 4) % 2).astype(bool)
    cloth[rect & stripes] = [0.8, 0.1, 0.2]
    cloth[rect & ~stripes] = [0.95, 0.85, 0.3]
    cloth_mask = rect.astype(np.float32)
    sh_y = (cy - H * 0.2) if seed == 0 else (y_split - ry * 0.15)
    kpts = np.array([[cx, cy - H * 0.35, 1],
                     [cx, sh_y, 1],
                     [cx - W * 0.2, sh_y, 1],
                     [cx - W * 0.25, cy, 1],
                     [cx - W * 0.25, cy + H * 0.2, 1],
                     [cx + W * 0.2, sh_y, 1],
                     [cx + W * 0.25, cy, 1],
                     [cx + W * 0.25, cy + H * 0.2, 1]]
                    + [[0, 0, 0]] * 10, np.float32)
    return {"image": image, "cloth": cloth, "cloth_mask": cloth_mask,
            "parse": parse, "keypoints": kpts}
