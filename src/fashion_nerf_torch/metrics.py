"""Image quality metrics; counterpart of `fashion_nerf.metrics`.

PSNR = −10·log₁₀(MSE). SSIM follows Wang et al.: 11×11 Gaussian window
σ = 1.5, K1 = 0.01, K2 = 0.03, VALID filtering, per channel then averaged,
in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse_to_psnr(m, max_val: float = 1.0):
    return -10.0 * torch.log10(m / (max_val ** 2) + 1e-12)


def psnr(pred, target, max_val: float = 1.0):
    """−10·log₁₀(MSE / max²), as a 0-d tensor."""
    return mse_to_psnr(torch.mean((pred.float() - target.float()) ** 2),
                       max_val)


def _gaussian_kernel(size: int, sigma: float, device):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, target, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Mean SSIM over an (H, W, C) image pair, as a 0-d tensor."""
    pred, target = pred.float(), target.float()
    C = pred.shape[-1]
    kern = _gaussian_kernel(filter_size, filter_sigma, pred.device)
    kern = kern[None, None].expand(C, 1, filter_size, filter_size)

    def filt(img):
        # depthwise VALID conv in full f32 (TF32 would lose the σ² = E[x²]
        # − μ² cancellation)
        x = img.permute(2, 0, 1)[None]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv2d(x, kern, groups=C)
        return y[0].permute(1, 2, 0)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_pp = torch.clamp(filt(pred * pred) - mu_pp, min=0.0)
    sigma_tt = torch.clamp(filt(target * target) - mu_tt, min=0.0)
    sigma_pt = filt(pred * target) - mu_pt
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    return torch.mean(num / den)
