"""Garment encoder of the conditioned field; counterpart of
`fashion_nerf.models.conditioned`.

`GarmentEncoder`: three stride-2 3×3 convolutions (16, 32, 64 features,
relu) over the (H, W, 7) conditioning stack, a global mean and a dense
projection → one garment code, broadcast to every ray of the scene. The
conditioned field itself is the NeRFMLP with its `cond` input.

The convolutions are flax's: "SAME" padding puts ⌊total/2⌋ rows before and
the rest after (0 and 1 for an even input at stride 2), so the input is
padded explicitly and the convolution takes no padding of its own. cuDNN
would run f32 convolutions in TF32; `conv_same` turns that off, so the card
computes what the CPU computes to f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, stride: int) -> tuple:
    """(before, after) padding of flax/XLA "SAME" along an axis of n."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x):
    """conv (no padding of its own) over NCHW x with "SAME" padding, in
    full f32 on every device."""
    k, s = conv.kernel_size[0], conv.stride[0]
    (t, b), (l, r) = (same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return conv(F.pad(x, (l, r, t, b)))


def lecun_normal_(weight, fan_in: int, generator):
    """flax's default kernel init: a normal truncated at ±2σ with variance
    1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)


def load_conv(conv: nn.Conv2d, tree: dict) -> None:
    """Copy a flax conv {"kernel" (kh, kw, in, out) HWIO, "bias"} into an
    OIHW nn.Conv2d."""
    kern = np.asarray(tree["kernel"], np.float32).transpose(3, 2, 0, 1)
    if kern.shape != tuple(conv.weight.shape):
        raise ValueError(f"conv kernel {kern.shape} does not fit "
                         f"{tuple(conv.weight.shape)}")
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(kern))
        conv.bias.copy_(torch.tensor(np.asarray(tree["bias"], np.float32)))


def load_dense(layer: nn.Linear, tree: dict) -> None:
    """Copy a flax Dense {"kernel" (in, out), "bias"} into an nn.Linear."""
    kern = np.asarray(tree["kernel"], np.float32).T
    if kern.shape != tuple(layer.weight.shape):
        raise ValueError(f"dense kernel {kern.shape[::-1]} does not fit "
                         f"{tuple(layer.weight.shape[::-1])}")
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(kern))
        layer.bias.copy_(torch.tensor(np.asarray(tree["bias"], np.float32)))


class GarmentEncoder(nn.Module):
    """(B, H, W, C) conditioning stack → (B, out_dim) garment code."""

    def __init__(self, out_dim: int = 64, features=(16, 32, 64),
                 in_channels: int = 7):
        super().__init__()
        chans = (in_channels,) + tuple(features)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=0)
            for i in range(len(features)))
        self.proj = nn.Linear(chans[-1], out_dim)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            h = torch.relu(conv_same(conv, h))
        return self.proj(h.mean(dim=(2, 3)))

    def load_flax(self, tree: dict) -> "GarmentEncoder":
        """Take the reference's parameter tree (conv_i, proj)."""
        p = tree.get("params", tree)
        for i, conv in enumerate(self.convs):
            load_conv(conv, p[f"conv_{i}"])
        load_dense(self.proj, p["proj"])
        return self

    def init_flax_(self, generator: torch.Generator) -> "GarmentEncoder":
        """flax's default init (LeCun-normal kernels, zero biases)."""
        for conv in self.convs:
            lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            nn.init.zeros_(conv.bias)
        lecun_normal_(self.proj.weight, self.proj.weight.shape[1], generator)
        nn.init.zeros_(self.proj.bias)
        return self


def encode_garment(encoder: GarmentEncoder, cond_stack):
    """cond_stack (H, W, C) or (B, H, W, C) → (out_dim,) / (B, out_dim)."""
    single = cond_stack.dim() == 3
    out = encoder(cond_stack[None] if single else cond_stack)
    return out[0] if single else out
