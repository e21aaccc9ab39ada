"""Image quality metrics; counterpart of `fashion_nerf.metrics` (PSNR only)."""

from __future__ import annotations

import torch


def psnr(pred, target, max_val: float = 1.0):
    """−10·log₁₀(MSE / max²), as a 0-d tensor."""
    m = torch.mean((pred.float() - target.float()) ** 2)
    return -10.0 * torch.log10(m / (max_val ** 2) + 1e-12)
