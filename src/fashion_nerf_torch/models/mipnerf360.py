"""The two nets of mip-NeRF 360 (Barron et al., CVPR 2022): the NeRF MLP
and the σ-only proposal MLP, both on the integrated encoding of contracted
cone Gaussians (core/cones.py).

- NeRF MLP (`mipnerf360` preset: 8×1024, L = 12): a ReLU trunk on the 6L
  IPE features, the features joined again after each skip layer as
  [h, γ] (the public code's order); raw σ off the trunk; a bottleneck
  layer (no activation) joined with the view encoding [d̂, sin, cos]
  (degree 4: 27 features) into one ReLU view layer; rgb = sigmoid with a
  padding of 0.001 on each side.
- Proposal MLP (4×256): the same trunk without the view branch; σ only.

σ = softplus(raw − 1) is applied where the weights are composited
(render/m360.py). Layer names follow the reference's trees (trunk_i,
sigma_head, feature, view_0, rgb_head), so `roofline.eval_macs` counts
them. The render evaluates the nets through the wide-field kernel K7
(kernels/widefield.py); `forward` is the float32 function of the module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from fashion_nerf_torch.core.cones import ipe, viewdir_encoding

RGB_PADDING = 0.001
DENSITY_BIAS = -1.0


class MipMLP(nn.Module):
    """One net of mip-NeRF 360; with bottleneck > 0 the NeRF MLP (view
    branch), else the σ-only proposal."""

    def __init__(self, depth: int, width: int, skips: Tuple[int, ...],
                 ipe_deg: int, bottleneck: int = 0, view_width: int = 0,
                 dir_deg: int = 4):
        super().__init__()
        self.depth, self.width, self.skips = depth, width, tuple(skips)
        self.ipe_deg, self.dir_deg = ipe_deg, dir_deg
        self.bottleneck, self.view_width = bottleneck, view_width
        cx = 6 * ipe_deg
        ins = [cx if i == 0 else width + (cx if (i - 1) in self.skips else 0)
               for i in range(depth)]
        self.trunk = nn.ModuleList(nn.Linear(k, width) for k in ins)
        self.sigma_head = nn.Linear(width, 1)
        if bottleneck:
            cd = 3 + 6 * dir_deg
            self.feature = nn.Linear(width, bottleneck)
            self.view_0 = nn.Linear(bottleneck + cd, view_width)
            self.rgb_head = nn.Linear(view_width, 3)

    @property
    def has_vd(self) -> bool:
        return self.bottleneck > 0

    def named_dense(self):
        """(reference layer name, nn.Linear) in the reference's order."""
        out = [(f"trunk_{i}", layer) for i, layer in enumerate(self.trunk)]
        heads = (("sigma_head", "feature", "view_0", "rgb_head")
                 if self.has_vd else ("sigma_head",))
        return out + [(n, getattr(self, n)) for n in heads]

    def forward(self, mean, var, viewdirs=None):
        """Gaussians (n, 3) each, view directions (n, 3) → (rgb (n, 3) after
        the padded sigmoid, or None, raw σ (n,)), float32."""
        x = ipe(mean, var, self.ipe_deg)
        h = x
        for i, layer in enumerate(self.trunk):
            h = torch.relu(layer(h))
            if i in self.skips and i + 1 < self.depth:
                h = torch.cat([h, x], dim=-1)
        sigma = self.sigma_head(h)[..., 0]
        if not self.has_vd:
            return None, sigma
        bn = self.feature(h)
        v = torch.relu(self.view_0(torch.cat(
            [bn, viewdir_encoding(viewdirs, self.dir_deg)], dim=-1)))
        rgb = torch.sigmoid(self.rgb_head(v))
        return rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING, sigma

    def to_tree(self) -> dict:
        """{"params": {name: {"kernel": (in, out), "bias": (out,)}}}, numpy."""
        return {"params": {
            name: {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                   "bias": layer.bias.detach().cpu().numpy().copy()}
            for name, layer in self.named_dense()}}


def nets_of(cfg) -> dict:
    """{"proposal", "fine"}: the constructor arguments of the two nets of a
    `mipnerf360`-style config (model.ipe_deg > 0)."""
    m, p = cfg.model, cfg.proposal
    return {"proposal": dict(depth=p.net_depth, width=p.net_width, skips=(),
                             ipe_deg=m.ipe_deg),
            "fine": dict(depth=m.net_depth, width=m.net_width,
                         skips=tuple(m.skips), ipe_deg=m.ipe_deg,
                         bottleneck=m.bottleneck_width,
                         view_width=m.view_width,
                         dir_deg=m.posenc_dir)}


def from_tree(tree, device=None, **kwargs) -> MipMLP:
    """A MipMLP holding a parameter tree's weights (numpy or tensors)."""
    net = MipMLP(**kwargs).to(device)
    p = tree["params"] if "params" in tree else tree

    def t(a):
        return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a),
                               dtype=torch.float32)

    with torch.no_grad():
        for name, layer in net.named_dense():
            k = t(p[name]["kernel"])
            if tuple(k.shape) != tuple(layer.weight.shape[::-1]):
                raise ValueError(f"{name}: kernel {tuple(k.shape)} does not "
                                 f"fit {tuple(layer.weight.shape[::-1])}")
            layer.weight.copy_(k.t())
            layer.bias.copy_(t(p[name]["bias"]))
    return net


def init_nets(cfg, generator: torch.Generator, device=None) -> dict:
    """{"proposal", "fine"} MipMLPs of the config, initialised as flax's
    Dense: LeCun-normal kernels truncated at ±2σ, zero biases."""
    out = {}
    for name, kw in nets_of(cfg).items():
        net = MipMLP(**kw)
        with torch.no_grad():
            for _, layer in net.named_dense():
                std = (1.0 / layer.weight.shape[1]) ** 0.5 \
                    / 0.87962566103423978
                w = torch.empty(layer.weight.shape[::-1])
                torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std,
                                            2.0 * std, generator=generator)
                layer.weight.copy_(w.t())
                layer.bias.zero_()
        out[name] = net.to(device) if device is not None else net
    return out
