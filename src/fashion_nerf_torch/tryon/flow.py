"""Dense appearance-flow cloth warp; counterpart of
`fashion_nerf.tryon.flow`."""

from __future__ import annotations

import torch

from fashion_nerf_torch.tryon.tps import grid_sample


def flow_warp(img, flow, padding_value: float = 0.0,
              normalized: bool = True):
    """Backward-warp img (H, W, C) by flow (Ho, Wo, 2) of (dx, dy) offsets,
    in [-1, 1] units when `normalized`, else in pixels: output pixel o
    reads source position o + flow[o]."""
    Ho, Wo = flow.shape[:2]
    dev = flow.device
    ys = torch.linspace(-1.0, 1.0, Ho, device=dev)
    xs = torch.linspace(-1.0, 1.0, Wo, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy], dim=-1)
    if not normalized:
        H, W = img.shape[:2]
        flow = flow * torch.tensor([2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)],
                                   device=dev)
    return grid_sample(img, base + flow, padding_value)
