"""Thin-plate-spline cloth warp; counterpart of `fashion_nerf.tryon.tps`.

`fit_tps` solves the (K+3)² TPS system (radial basis U(r) = r² log r² and
an affine part) in f32; `tps_grid` evaluates the warp on the pixel grid;
`grid_sample` samples bilinearly at (x, y) in [-1, 1] with the corners on
pixel centres (torch's `align_corners=True`), every out-of-range corner tap
reading `padding_value`, as the reference's gather does.
"""

from __future__ import annotations

import torch


def _u(r2):
    """U(r) = r² log r², 0 at r = 0."""
    return torch.where(r2 == 0.0, torch.zeros_like(r2),
                       r2 * torch.log(torch.clamp(r2, min=1e-12)))


def fit_tps(src_pts, dst_pts, reg: float = 1e-6) -> dict:
    """TPS mapping src → dst for (K, 2) control points in [-1, 1] (x, y);
    reg: Tikhonov weight on the bending term. → {w (K,2), a (3,2), src}."""
    K = src_pts.shape[0]
    dev = src_pts.device
    d2 = torch.sum((src_pts[:, None, :] - src_pts[None, :, :]) ** 2, -1)
    Phi = _u(d2) + reg * torch.eye(K, device=dev)
    P = torch.cat([torch.ones((K, 1), device=dev), src_pts], dim=1)
    A = torch.cat([torch.cat([Phi, P], dim=1),
                   torch.cat([P.t(), torch.zeros((3, 3), device=dev)], 1)])
    b = torch.cat([dst_pts, torch.zeros((3, 2), device=dev)])
    sol = torch.linalg.solve(A, b)
    return {"w": sol[:K], "a": sol[K:], "src": src_pts}


def tps_apply(params: dict, pts):
    """The fitted TPS at pts (..., 2) → (..., 2)."""
    w, a, src = params["w"], params["a"], params["src"]
    d2 = torch.sum((pts[..., None, :] - src) ** 2, -1)
    return _u(d2) @ w + (a[0] + pts @ a[1:])


def tps_grid(params: dict, H: int, W: int):
    """(H, W, 2) sampling grid in [-1, 1]: where each output pixel reads
    from in the source image (a backward warp)."""
    dev = params["w"].device
    ys = torch.linspace(-1.0, 1.0, H, device=dev)
    xs = torch.linspace(-1.0, 1.0, W, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return tps_apply(params, torch.stack([gx, gy], dim=-1))


def grid_sample(img, grid, padding_value: float = 0.0):
    """Bilinear sample of img (H, W, C) at grid (Ho, Wo, 2) of (x, y) in
    [-1, 1] → (Ho, Wo, C); out-of-range taps read padding_value."""
    H, W = img.shape[:2]
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1

    def gather(yy, xx):
        inside = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        xi = torch.clamp(xx, 0, W - 1).long()
        yi = torch.clamp(yy, 0, H - 1).long()
        vals = img[yi, xi]
        return torch.where(inside[..., None], vals,
                           torch.full_like(vals, padding_value))

    return (gather(y0, x0) * (wy0 * wx0)[..., None]
            + gather(y0, x1) * (wy0 * wx1)[..., None]
            + gather(y1, x0) * (wy1 * wx0)[..., None]
            + gather(y1, x1) * (wy1 * wx1)[..., None])


def tps_warp(img, src_pts, dst_pts, out_hw=None, reg: float = 1e-6,
             padding_value: float = 0.0):
    """Warp img so that dst_pts land on src_pts: fit the TPS from output
    coordinates to source coordinates, then sample bilinearly."""
    H, W = out_hw or img.shape[:2]
    grid = tps_grid(fit_tps(dst_pts, src_pts, reg), H, W)
    return grid_sample(img, grid, padding_value)
