"""Camera model: pixel grid → world-space rays; NDC reparameterization.

Counterpart of `fashion_nerf.core.cameras`. The camera looks down its -z
axis, +x right, +y up; `c2w` is a 3×4 (or 4×4) camera-to-world matrix.
"""

from __future__ import annotations

import torch


def generate_rays(H: int, W: int, focal: float, c2w, device=None):
    """All rays through a pixel grid → (rays_o, rays_d), each (H, W, 3) f32.

    Directions are NOT normalized (δ scaling in volume rendering multiplies
    by ‖d‖). The rotation is a plain f32 sum of three products."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    i = torch.arange(W, dtype=torch.float32, device=c2w.device)
    j = torch.arange(H, dtype=torch.float32, device=c2w.device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")                  # (H, W)
    dirs = torch.stack([(ii - W * 0.5) / focal,
                        -(jj - H * 0.5) / focal,
                        -torch.ones_like(ii)], dim=-1)            # (H, W, 3)
    rot = c2w[:3, :3]
    rays_d = (dirs[..., 0:1] * rot[:, 0] + dirs[..., 1:2] * rot[:, 1]
              + dirs[..., 2:3] * rot[:, 2])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Shift rays to the z=-near plane and map them to NDC space (LLFF)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz
    return (torch.stack([o0, o1, o2], dim=-1),
            torch.stack([d0, d1, d2], dim=-1))
