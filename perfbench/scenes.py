"""Training scenes the benchmark makes, on the device (`make`).

`spheres`: the procedural scene the committed flagship weights were
trained on (synthetic_spheres_seed0): a cluster of five soft coloured
spheres with a high-frequency albedo pattern, seen from `n_views` cameras
at radius 4 around it (θ evenly over 360° plus a jitter, φ from −40° to
−20°, z up), each view a dense 128-sample quadrature of the analytic field
on a white background. The cameras' draws are numpy's `default_rng(seed)`
as the scene defines them; the images are computed in float32 torch on
the device. Two makers of this scene agree to float rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPHERES = [   # centre, radius, colour, density
    ((0.0, 0.0, 0.0), 0.9, (0.9, 0.2, 0.15), 40.0),
    ((0.9, 0.4, 0.3), 0.45, (0.15, 0.7, 0.9), 60.0),
    ((-0.7, -0.5, 0.4), 0.5, (0.2, 0.85, 0.25), 50.0),
    ((0.15, 0.8, -0.55), 0.4, (0.95, 0.85, 0.1), 70.0),
    ((-0.3, 0.6, 0.6), 0.35, (0.55, 0.25, 0.8), 55.0),
]
TEXTURES = [  # albedo pattern: frequency (rad per cluster unit), phase
    ((41.0, 53.0, 47.0), (0.0, 1.3, 2.1)),
    ((59.0, 43.0, 67.0), (0.7, 0.2, 1.9)),
    ((47.0, 61.0, 37.0), (2.4, 0.9, 0.3)),
    ((67.0, 47.0, 53.0), (1.1, 2.8, 0.6)),
    ((53.0, 67.0, 59.0), (0.4, 1.7, 2.9)),
]


def field(pts, scale: float, sharp: float, texture: float):
    """Analytic field: pts (..., 3) → rgb (..., 3), σ (...)."""
    x, y, z = pts.unbind(-1)
    sigma = torch.zeros_like(x)
    chans = [torch.zeros_like(x) for _ in range(3)]
    for (c, r, col, dens), (freq, phase) in zip(SPHERES, TEXTURES):
        d = torch.sqrt((x - scale * c[0]) ** 2 + (y - scale * c[1]) ** 2
                       + (z - scale * c[2]) ** 2)
        occ = dens / (1.0 + torch.exp(torch.clamp(sharp * (d - r * scale),
                                                  -30, 30)))
        mod = 1.0 + texture * (torch.sin(freq[0] / scale * x + phase[0])
                               * torch.sin(freq[1] / scale * y + phase[1])
                               * torch.sin(freq[2] / scale * z + phase[2]))
        for ch in range(3):
            chans[ch] = chans[ch] + occ * torch.clamp(col[ch] * mod, 0, 1)
        sigma = sigma + occ
    rgb = torch.stack(chans, -1) / torch.clamp(sigma[..., None], min=1e-8)
    rgb = torch.where(sigma[..., None] > 1e-8, rgb, 1.0)
    return rgb, sigma


def pose(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """(3, 4) camera-to-world: from (0, 0, radius) turned by φ about x,
    then by θ about z, looking at the origin."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    rot_phi = np.array([[1, 0, 0], [0, math.cos(ph), -math.sin(ph)],
                        [0, math.sin(ph), math.cos(ph)]])
    rot_th = np.array([[math.cos(th), -math.sin(th), 0],
                       [math.sin(th), math.cos(th), 0], [0, 0, 1]])
    rot = rot_th @ rot_phi
    return np.concatenate([rot, rot @ np.array([[0.0], [0.0], [radius]])],
                          axis=1).astype(np.float32)


def render_view(H, W, focal, c2w, device, scale, sharp, texture,
                n_samples=128, near=2.0, far=6.0):
    """One white-background view of the field by dense quadrature."""
    c2w = torch.as_tensor(c2w, device=device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], -1)
    d = dirs @ c2w[:, :3].T
    t = torch.linspace(near, far, n_samples, device=device)
    pts = c2w[:, 3] + d[..., None, :] * t[:, None]
    rgb, sigma = field(pts, scale, sharp, texture)
    delta = (far - near) / (n_samples - 1) * torch.linalg.norm(
        d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = alpha * trans
    img = (w[..., None] * rgb).sum(-2) + (1.0 - w.sum(-1))[..., None]
    return img.clamp(0, 1)


def spheres(spec: dict, device) -> dict:
    """The scene of a traffic file's "scene" group: {"n_views", "H", "W",
    "seed", "scale", "sharp", "texture"} → images (N, H, W, 3) on the
    device, poses (N, 3, 4) numpy, focal."""
    rng = np.random.default_rng(spec["seed"])
    n, H, W = spec["n_views"], spec["H"], spec["W"]
    focal = 0.9 * W
    thetas = np.linspace(0, 360, n, endpoint=False) + rng.uniform(0, 5)
    phis = rng.uniform(-40, -20, size=n)
    poses = np.stack([pose(t, p, 4.0) for t, p in zip(thetas, phis)])
    images = torch.stack([
        render_view(H, W, focal, p, device, spec["scale"], spec["sharp"],
                    spec["texture"]) for p in poses])
    return {"images": images, "poses": poses, "focal": float(focal)}


def forward(spec: dict, seed: int, device) -> dict:
    """A forward-facing (LLFF-like) scene of the same field: {"n_views",
    "H", "W", "scale", "sharp", "texture"}; cameras near z = 4 looking down
    −z with lateral offsets drawn from the run's seed (x ±0.4, y ±0.3, z
    ±0.2), focal 1.2·W."""
    rng = np.random.default_rng(seed)
    n, H, W = spec["n_views"], spec["H"], spec["W"]
    focal = 1.2 * W
    poses = []
    for _ in range(n):
        c2w = np.eye(4, dtype=np.float32)[:3]
        c2w[0, 3] = rng.uniform(-0.4, 0.4)
        c2w[1, 3] = rng.uniform(-0.3, 0.3)
        c2w[2, 3] = 4.0 + rng.uniform(-0.2, 0.2)
        poses.append(c2w)
    poses = np.stack(poses)
    images = torch.stack([
        render_view(H, W, focal, p, device, spec["scale"], spec["sharp"],
                    spec["texture"]) for p in poses])
    return {"images": images, "poses": poses, "focal": float(focal)}


def make(spec: dict, seed: int, device) -> dict:
    """The scene a traffic file's "scene" group names."""
    if spec["kind"] == "spheres":
        return spheres(spec, device)
    if spec["kind"] == "forward":
        return forward(spec, seed, device)
    raise ValueError(f"scene kind {spec['kind']!r}")
