"""Try-on preprocessing pipeline; counterpart of
`fashion_nerf.tryon.pipeline`.

A person/cloth pair goes to the device once, then: resize, parse masks and
the cloth-agnostic image, the pose raster, keypoint-grid TPS
correspondences (plus the learned matcher's residual on the targets, when
its committed weights are used), the TPS cloth warp, and the (H, W, 7)
conditioning stack [warped cloth (3) | warped mask | garment mask | body
mask | pose map] that the garment encoder takes. `preprocess_cli` is the
body of `python -m fashion_nerf_torch preprocess`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fashion_nerf_torch.tryon.pose import rasterize_keypoints
from fashion_nerf_torch.tryon.segmentation import make_agnostic, resize_image
from fashion_nerf_torch.tryon.tps import fit_tps, grid_sample, tps_grid

PAIR_KEYS = ("image", "cloth", "cloth_mask", "parse", "keypoints")


def to_device(pair: dict, device=None) -> tuple:
    """The pair's arrays as tensors on `device`, in PAIR_KEYS order."""
    out = []
    for k in PAIR_KEYS:
        a = np.asarray(pair[k])
        dt = torch.int32 if k == "parse" else torch.float32
        out.append(torch.as_tensor(a, device=device).to(dt))
    return tuple(out)


def _norm(H: int, W: int, device):
    return torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], device=device)


def garment_control_points(cloth_mask, k_side: int = 5):
    """K = 2·k_side control points evenly spaced down the left and right
    edges of the cloth mask's bounding box, in [-1, 1] (x, y)."""
    H, W = cloth_mask.shape
    dev = cloth_mask.device
    ys = torch.any(cloth_mask > 0.5, dim=1)
    xs = torch.any(cloth_mask > 0.5, dim=0)

    def bounds(v, n):
        idx = torch.arange(n, dtype=torch.float32, device=dev)
        lo = torch.min(torch.where(v, idx, torch.full_like(idx, n * 1.0)))
        hi = torch.max(torch.where(v, idx, torch.full_like(idx, -1.0)))
        return lo, torch.maximum(hi, lo + 1.0)

    y0, y1 = bounds(ys, H)
    x0, x1 = bounds(xs, W)
    t = torch.linspace(0.0, 1.0, k_side, device=dev)
    ys_pts = y0 + t * (y1 - y0)
    left = torch.stack([x0.expand(k_side), ys_pts], -1)
    right = torch.stack([x1.expand(k_side), ys_pts], -1)
    return torch.cat([left, right], 0) / _norm(H, W, dev) - 1.0


def _vertical_bounds(mask):
    """(y0, y1) row bounds of a binary mask; the middle third of the image
    when the mask is empty."""
    H = mask.shape[0]
    dev = mask.device
    rows = torch.any(mask > 0.5, dim=1)
    idx = torch.arange(H, dtype=torch.float32, device=dev)
    has = torch.any(rows)
    y0 = torch.min(torch.where(rows, idx, torch.full_like(idx, H * 1.0)))
    y1 = torch.max(torch.where(rows, idx, torch.full_like(idx, -1.0)))
    y0 = torch.where(has, y0, torch.tensor(H / 3.0, device=dev))
    y1 = torch.where(has, torch.maximum(y1, y0 + 1.0),
                     torch.tensor(2.0 * H / 3.0, device=dev))
    return y0, y1


def _row_extents(mask, y_centers, band_h, k_rows: int):
    """For each band centre yᵢ, the (left, mid, right) x-extents of the mask
    within rows [yᵢ − band_h, yᵢ + band_h] → (3·k_rows, 2) pixel points; an
    empty band gives probe points at 0.4 W and 0.6 W."""
    H, W = mask.shape
    dev = mask.device
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    pts = []
    for i in range(k_rows):
        yc = y_centers[i]
        band = (rows >= yc - band_h) & (rows <= yc + band_h)
        m = torch.any((mask > 0.5) & band, dim=0)
        has = torch.any(m)
        x0 = torch.where(has, torch.min(torch.where(
            m, cols, torch.full_like(cols, W * 1.0))),
            torch.tensor(W * 0.4, device=dev))
        x1 = torch.where(has, torch.max(torch.where(
            m, cols, torch.full_like(cols, -1.0))),
            torch.tensor(W * 0.6, device=dev))
        x1 = torch.maximum(x1, x0 + 1.0)
        xm = 0.5 * (x0 + x1)
        for x in (x0, xm, x1):
            pts.append(torch.stack([x, yc]))
    return torch.stack(pts)


def keypoint_grid_correspondences(cloth_mask, garment_mask, keypoints,
                                  H: int, W: int, k_rows: int = 6):
    """Sources on the cloth's per-row silhouette, targets on that of the
    person's garment region, the targets' vertical span anchored by the
    shoulder (OpenPose 2/5) and hip (8/11) keypoints blended with the parse
    bounds → (src, dst), each (3·k_rows, 2) in [-1, 1] (x, y)."""
    dev = cloth_mask.device
    kp = torch.as_tensor(keypoints, dtype=torch.float32, device=dev)
    cy0, cy1 = _vertical_bounds(cloth_mask)
    gy0, gy1 = _vertical_bounds(garment_mask)
    sh_vis = torch.stack([kp[2, 2] > 0, kp[5, 2] > 0])
    hip_vis = torch.stack([kp[8, 2] > 0, kp[11, 2] > 0])
    sh_y = torch.stack([kp[2, 1], kp[5, 1]])
    hip_y = torch.stack([kp[8, 1], kp[11, 1]])
    y_sh = torch.min(torch.where(sh_vis, sh_y, torch.full_like(sh_y,
                                                               H * 1.0)))
    y_hip = torch.max(torch.where(hip_vis, hip_y,
                                  torch.full_like(hip_y, -1.0)))
    y0t = torch.where(torch.any(sh_vis), 0.5 * (y_sh + gy0), gy0)
    y1t = torch.where(torch.any(hip_vis), 0.5 * (y_hip + gy1), gy1)
    y1t = torch.maximum(y1t, y0t + 1.0)
    t = torch.linspace(0.0, 1.0, k_rows, device=dev)
    band_c = torch.clamp((cy1 - cy0) / (2.0 * (k_rows - 1)), min=1.0)
    band_t = torch.clamp((y1t - y0t) / (2.0 * (k_rows - 1)), min=1.0)
    src = _row_extents(cloth_mask, cy0 + t * (cy1 - cy0), band_c, k_rows)
    dst = _row_extents(garment_mask, y0t + t * (y1t - y0t), band_t, k_rows)
    norm = _norm(H, W, dev)
    return src / norm - 1.0, dst / norm - 1.0


def torso_targets(keypoints, H: int, W: int, k_side: int = 5, device=None):
    """Target control points from the pose: shoulder → hip down each body
    side (OpenPose 2/5 shoulders, 8/11 hips), in [-1, 1] (x, y)."""
    kp = torch.as_tensor(keypoints, dtype=torch.float32, device=device)
    dev = kp.device

    def side(sh, hip, fallback_x):
        ok = (kp[sh, 2] > 0) & (kp[hip, 2] > 0)
        a = torch.where(ok, kp[sh, :2],
                        torch.tensor([fallback_x, H * 0.3], device=dev))
        b = torch.where(ok, kp[hip, :2],
                        torch.tensor([fallback_x, H * 0.7], device=dev))
        t = torch.linspace(0.0, 1.0, k_side, device=dev)[:, None]
        return a + t * (b - a)

    pts = torch.cat([side(2, 8, W * 0.35), side(5, 11, W * 0.65)], 0)
    return pts / _norm(H, W, dev) - 1.0


def _preprocess_device(image, cloth, cloth_mask, parse, keypoints, H: int,
                       W: int, matcher=None) -> dict:
    """The preprocessing on the inputs' device → dict agnostic,
    warped_cloth, warped_mask, pose_heat, cond (H, W, 7), garment_mask.

    matcher: a GarmentMatcher whose residual moves the TPS targets, or None
    for the procedural keypoint-grid warp."""
    image = resize_image(image, H, W)
    cloth = resize_image(cloth, H, W)
    cloth_mask = resize_image(cloth_mask[..., None], H, W)[..., 0]
    parse_f = resize_image(parse.float()[..., None], H, W,
                           method="nearest")[..., 0].to(torch.int32)
    agnostic, masks = make_agnostic(image, parse_f)
    heat = rasterize_keypoints(keypoints, H, W, sigma=max(2.0, H / 32))
    pose_map = heat.amax(dim=-1, keepdim=True)
    src, dst = keypoint_grid_correspondences(cloth_mask, masks["garment"],
                                             keypoints, H, W)
    if matcher is not None:
        person = torch.cat([agnostic, masks["garment"][..., None], pose_map],
                           dim=-1)
        dst = dst + matcher(person, torch.cat([cloth, cloth_mask[..., None]],
                                              dim=-1))
    # backward map: output (person frame) coordinates → cloth coordinates
    grid = tps_grid(fit_tps(dst, src), H, W)
    warped_cloth = grid_sample(cloth, grid, padding_value=1.0)
    warped_mask = grid_sample(cloth_mask[..., None], grid)[..., 0]
    cond = torch.cat([warped_cloth, warped_mask[..., None],
                      masks["garment"][..., None], masks["body"][..., None],
                      pose_map], dim=-1)
    return {"agnostic": agnostic, "warped_cloth": warped_cloth,
            "warped_mask": warped_mask, "pose_heat": heat, "cond": cond,
            "garment_mask": masks["garment"]}


def resolve_matcher(cfg=None, device=None):
    """The matcher of a run: the committed asset on `device` when
    cfg.tryon.use_matcher (the default) and the asset exists, else None."""
    if cfg is not None and not cfg.tryon.use_matcher:
        return None
    from fashion_nerf_torch.tryon.matcher import load_matcher
    return load_matcher(cfg.tryon.matcher_asset if cfg is not None else "",
                        device=device)


def build_conditioning(pair: dict, H: int, W: int, cfg=None, device=None):
    """A host pair → its (H, W, 7) conditioning stack on `device`."""
    with torch.no_grad():
        return _preprocess_device(*to_device(pair, device), H=H, W=W,
                                  matcher=resolve_matcher(cfg, device))["cond"]


def preprocess_cli(cfg, device=None) -> int:
    """`preprocess`: the pipeline over every pair under data.root (or the
    procedural pair), writing <out>/<name>/preprocess/<id>_{agnostic,
    warped_cloth,tryon_overlay}.png and <id>_cond.npy."""
    from fashion_nerf_torch.data.viton import load_viton_pair, synth_viton_pair
    from fashion_nerf_torch.png import write_png

    root = cfg.data.root
    if root and os.path.isdir(os.path.join(root, "image")):
        ids = sorted(os.path.splitext(f)[0]
                     for f in os.listdir(os.path.join(root, "image")))
        pairs = [(i, load_viton_pair(root, i)) for i in ids]
    else:
        pairs = [("synthetic", synth_viton_pair())]
    out_dir = os.path.join(cfg.out_dir, cfg.name, "preprocess")
    os.makedirs(out_dir, exist_ok=True)
    matcher = resolve_matcher(cfg, device)
    for pid, pair in pairs:
        H, W = np.asarray(pair["image"]).shape[:2]
        with torch.no_grad():
            out = _preprocess_device(*to_device(pair, device), H=H, W=W,
                                     matcher=matcher)
        wm = out["warped_mask"][..., None]
        out["tryon_overlay"] = (out["agnostic"] * (1.0 - wm)
                                + out["warped_cloth"] * wm)
        for name in ("agnostic", "warped_cloth", "tryon_overlay"):
            img = np.clip(out[name].cpu().numpy(), 0, 1)
            write_png(os.path.join(out_dir, f"{pid}_{name}.png"),
                      (img * 255).astype(np.uint8))
        np.save(os.path.join(out_dir, f"{pid}_cond.npy"),
                out["cond"].cpu().numpy().astype(np.float32))
    print(json.dumps({"pairs": len(pairs), "out": out_dir,
                      "matcher": matcher is not None}))
    return 0
