"""Procedural multi-view scene generator — hermetic ground truth.

A copy of `fashion_nerf.data.synthetic` (importing the reference module
imports its package's `data/__init__.py`, which imports JAX). The NumPy
code is the reference's, so the arrays are bitwise the reference's
(tests/test_torch_train_data.py holds them so); `field_torch` is the
torch counterpart of its jax.numpy mirror `field_jnp`, for the analytic
ground truth on the device (fashion_nerf_torch/quality.py).
The scene is a cluster of colored soft spheres rendered with dense
quadrature, so training runs with zero downloads.
"""

from __future__ import annotations

import numpy as np


def _pose_spherical(theta_deg: float, phi_deg: float, radius: float):
    """Camera on a sphere looking at the origin (standard blender-style)."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    # start at (0,0,r) looking down -z, rotate phi about x then theta about z
    trans = np.eye(4); trans[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1, 1] = rot_phi[2, 2] = np.cos(ph)
    rot_phi[1, 2], rot_phi[2, 1] = -np.sin(ph), np.sin(ph)
    rot_th = np.eye(4)
    rot_th[0, 0] = rot_th[1, 1] = np.cos(th)
    rot_th[0, 1], rot_th[1, 0] = -np.sin(th), np.sin(th)
    return (rot_th @ rot_phi @ trans)[:3].astype(np.float32)


_SPHERES = [
    # (center, radius, color, density) — sized so objects cover a meaningful
    # image fraction; a near-all-white scene admits a white-fog local optimum
    (np.array([0.0, 0.0, 0.0]), 0.9, np.array([0.9, 0.2, 0.15]), 40.0),
    (np.array([0.9, 0.4, 0.3]), 0.45, np.array([0.15, 0.7, 0.9]), 60.0),
    (np.array([-0.7, -0.5, 0.4]), 0.5, np.array([0.2, 0.85, 0.25]), 50.0),
    (np.array([0.15, 0.8, -0.55]), 0.4, np.array([0.95, 0.85, 0.1]), 70.0),
    (np.array([-0.3, 0.6, 0.6]), 0.35, np.array([0.55, 0.25, 0.8]), 55.0),
]

# per-sphere high-frequency albedo pattern: (freq (3,) rad per CLUSTER unit,
# phase (3,)). Frequencies sit well inside the L=10 posenc band but give
# wavelengths of a few pixels at the bench framing, so trained PSNR lands
# near real-scene anchors (~30 dB) instead of the saturated 44-54 dB the
# untextured scene gave — a −0.5 dB regression is visible there, invisible
# at 54 dB (VERDICT r2 weak #4 / next #6).
_TEXTURES = [
    (np.array([41.0, 53.0, 47.0]), np.array([0.0, 1.3, 2.1])),
    (np.array([59.0, 43.0, 67.0]), np.array([0.7, 0.2, 1.9])),
    (np.array([47.0, 61.0, 37.0]), np.array([2.4, 0.9, 0.3])),
    (np.array([67.0, 47.0, 53.0]), np.array([1.1, 2.8, 0.6])),
    (np.array([53.0, 67.0, 59.0]), np.array([0.4, 1.7, 2.9])),
]


def field_np(pts, scale: float = 1.0, sharp: float = 25.0,
             texture: float = 0.0):
    """Analytic field: pts (..., 3) → rgb (..., 3), sigma (...).

    scale shrinks the whole sphere cluster (object-centric framing — the
    bench scene uses 0.75 so the object covers a lego-like ~40% of the
    800×800 frame instead of filling the frustum); sharp sets the density
    falloff rate (the σ > 0.01 halo extends ln(dens/0.01)/sharp beyond each
    radius — 0.33 world units at 25, 0.10 at 80). texture (0..1) modulates
    each sphere's albedo with a high-frequency tri-axial sine pattern in
    cluster coordinates (framing-invariant) — the quality-gate hardener."""
    # NumPy perf discipline (measured, r3): (a) force f32 — one f64 scalar
    # leak (e.g. an np.float64 focal upstream) drops sin/exp to scalar libm,
    # ~325× slower than the f32 SIMD path; (b) work on CONTIGUOUS per-axis
    # arrays — ufuncs on strided (..., i) views and axis=-1 reductions on
    # (N, 3) also fall off the SIMD path (norm alone measured 2.5 s vs
    # 0.014 s per 2M points).
    pts = np.asarray(pts, np.float32)
    shp = pts.shape[:-1]
    flat = pts.reshape(-1, 3)
    x, y, z = (np.ascontiguousarray(flat[:, i]) for i in range(3))
    inv_s = np.float32(1.0 / max(scale, 1e-6))
    sigma = np.zeros(x.shape, np.float32)
    chans = [np.zeros(x.shape, np.float32) for _ in range(3)]
    wsum = np.zeros(x.shape, np.float32)
    for (c, r, col, dens), (freq, phase) in zip(_SPHERES, _TEXTURES):
        cx, cy, cz = (np.float32(scale) * c.astype(np.float32))
        dx, dy, dz = x - cx, y - cy, z - cz
        d = np.sqrt(dx * dx + dy * dy + dz * dz)
        occ = np.float32(dens) / (1.0 + np.exp(
            np.clip(np.float32(sharp) * (d - np.float32(r * scale)),
                    -30, 30), dtype=np.float32))
        mod = None
        if texture > 0.0:
            f = freq.astype(np.float32)
            p = phase.astype(np.float32)
            pat = (np.sin(f[0] * inv_s * x + p[0])
                   * np.sin(f[1] * inv_s * y + p[1])
                   * np.sin(f[2] * inv_s * z + p[2]))
            mod = 1.0 + np.float32(texture) * pat
        for ch in range(3):
            colv = np.float32(col[ch])
            if mod is None:
                chans[ch] += occ * colv
            else:
                chans[ch] += occ * np.clip(colv * mod, 0.0, 1.0)
        sigma += occ
        wsum += occ
    rgb = np.stack(chans, -1) / np.maximum(wsum[..., None], 1e-8)
    rgb = np.where(wsum[..., None] > 1e-8, rgb, 1.0)
    return (rgb.reshape(shp + (3,)).astype(np.float32),
            sigma.reshape(shp).astype(np.float32))


def field_torch(pts, scale: float = 1.0, sharp: float = 25.0,
                texture: float = 0.0):
    """torch mirror of field_np (the same analytic field, f32), on the
    device of `pts`: pts (..., 3) → rgb (..., 3), sigma (...)."""
    import torch
    pts = pts.float()
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    inv_s = np.float32(1.0 / max(scale, 1e-6))
    sigma = torch.zeros_like(x)
    chans = [torch.zeros_like(x) for _ in range(3)]
    wsum = torch.zeros_like(x)
    for (c, r, col, dens), (freq, phase) in zip(_SPHERES, _TEXTURES):
        cx, cy, cz = (float(v) for v in
                      np.float32(scale) * c.astype(np.float32))
        dx, dy, dz = x - cx, y - cy, z - cz
        d = torch.sqrt(dx * dx + dy * dy + dz * dz)
        occ = float(np.float32(dens)) / (1.0 + torch.exp(torch.clamp(
            float(np.float32(sharp)) * (d - float(np.float32(r * scale))),
            -30, 30)))
        mod = None
        if texture > 0.0:
            f = freq.astype(np.float32)
            p = phase.astype(np.float32)
            pat = (torch.sin(float(f[0] * inv_s) * x + float(p[0]))
                   * torch.sin(float(f[1] * inv_s) * y + float(p[1]))
                   * torch.sin(float(f[2] * inv_s) * z + float(p[2])))
            mod = 1.0 + float(np.float32(texture)) * pat
        for ch in range(3):
            colv = float(np.float32(col[ch]))
            if mod is None:
                chans[ch] = chans[ch] + occ * colv
            else:
                chans[ch] = chans[ch] + occ * torch.clamp(colv * mod, 0.0,
                                                          1.0)
        sigma = sigma + occ
        wsum = wsum + occ
    rgb = torch.stack(chans, -1) / torch.clamp(wsum[..., None], min=1e-8)
    rgb = torch.where(wsum[..., None] > 1e-8, rgb, 1.0)
    return rgb, sigma


def _render_view(H, W, focal, c2w, n_samples=128, near=2.0, far=6.0,
                 white_bkgd=True, scale=1.0, sharp=25.0, texture=0.0):
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W * .5) / focal, -(j - H * .5) / focal,
                     -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    t = np.linspace(near, far, n_samples, dtype=np.float32)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    rgb, sigma = field_np(pts, scale=scale, sharp=sharp, texture=texture)
    delta = (far - near) / (n_samples - 1) * np.linalg.norm(
        rays_d, axis=-1, keepdims=True)
    alpha = 1.0 - np.exp(-sigma * delta)
    trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = np.concatenate([np.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = alpha * trans
    img = (w[..., None] * rgb).sum(-2)
    acc = w.sum(-1)
    if white_bkgd:
        img = img + (1.0 - acc[..., None])
    return np.clip(img, 0, 1).astype(np.float32)


def make_forward_scene(n_views: int = 8, H: int = 48, W: int = 64,
                       seed: int = 0, n_samples: int = 128):
    """Forward-facing variant (LLFF-style geometry): cameras near z≈4 with
    small lateral offsets, all looking down -z — exercises the NDC path
    hermetically (BASELINE.json:9)."""
    rng = np.random.default_rng(seed)
    focal = 1.2 * W
    poses = []
    for i in range(n_views):
        c2w = np.eye(4, dtype=np.float32)[:3]
        c2w[0, 3] = rng.uniform(-0.4, 0.4)
        c2w[1, 3] = rng.uniform(-0.3, 0.3)
        c2w[2, 3] = 4.0 + rng.uniform(-0.2, 0.2)
        poses.append(c2w)
    poses = np.stack(poses)
    images = np.stack([_render_view(H, W, focal, p, n_samples,
                                    near=2.0, far=6.0) for p in poses])
    val_pose = np.eye(4, dtype=np.float32)[:3]
    val_pose[2, 3] = 4.1
    val_image = _render_view(H, W, focal, val_pose, n_samples,
                             near=2.0, far=6.0)
    return {
        "images": images, "poses": poses, "focal": float(focal),
        "val_image": val_image, "val_pose": val_pose,
        "near": 0.0, "far": 1.0,     # NDC bounds
        "H": H, "W": W,
    }


def make_synthetic_scene(n_views: int = 12, H: int = 64, W: int = 64,
                         seed: int = 0, n_samples: int = 128,
                         scale: float = 1.0, sharp: float = 25.0,
                         texture: float = 0.0):
    """→ dict(images (N,H,W,3), poses (N,3,4), focal, near, far, plus a
    held-out val view). Deterministic for a given seed. scale/sharp/texture
    shape the object framing and appearance (field_np) — the bench
    checkpoint trains on scale=0.5, sharp=80, texture=0.6 so background/
    occupancy statistics AND the quality-gate difficulty match the
    NeRF-synthetic scenes the flagship preset stands in for."""
    rng = np.random.default_rng(seed)
    focal = 0.9 * W
    thetas = np.linspace(0, 360, n_views, endpoint=False) + rng.uniform(0, 5)
    phis = rng.uniform(-40, -20, size=n_views)
    poses = np.stack([_pose_spherical(t, p, 4.0) for t, p in zip(thetas, phis)])
    images = np.stack([_render_view(H, W, focal, p, n_samples,
                                    scale=scale, sharp=sharp, texture=texture)
                       for p in poses])
    val_pose = _pose_spherical(33.3, -30.0, 4.0)
    val_image = _render_view(H, W, focal, val_pose, n_samples,
                             scale=scale, sharp=sharp, texture=texture)
    return {
        "images": images, "poses": poses, "focal": float(focal),
        "val_image": val_image, "val_pose": val_pose,
        "near": 2.0, "far": 6.0, "H": H, "W": W,
    }
