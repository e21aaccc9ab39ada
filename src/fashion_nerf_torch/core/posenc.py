"""Sinusoidal positional encoding γ; counterpart of `fashion_nerf.core.posenc`.

Layout: [x, sin(2⁰x), cos(2⁰x), …, sin(2^{L-1}x), cos(2^{L-1}x)], features
innermost (D dims per block).
"""

from __future__ import annotations

import torch


def posenc(x, num_freqs: int, include_input: bool = True):
    """Encode x (..., D) → (..., D·(2L [+1]))."""
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                     # (..., L, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)   # (..., L, 2D)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
