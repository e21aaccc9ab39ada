"""Canonical NeRF MLP; counterpart of `fashion_nerf.models.nerf_mlp`.

8×256 ReLU trunk, skip-concat [trunk_in, h] after trunk layer `skips`, σ
head off the trunk, RGB head off (feature ⊕ γ(d)). A conditioned field
(`cond_dim` > 0) takes trunk_in = [γ(x) | cond], so trunk_0's rows and
the skip layer's are [γ(x) | cond] and [γ(x) | cond | h]. The module
holds the weights of the port's fields; the render path evaluates them
through the packed kernels (kernels/posenc_mlp.py, kernels/slimmarch.py,
kernels/sigmamarch.py), and `forward` reproduces the reference's XLA
field.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from fashion_nerf_torch.core.posenc import posenc


class NeRFMLP(nn.Module):
    """Maps encoded position (and encoded view dir) to raw (rgb, σ).

    Layer names follow the reference's parameter tree: trunk_i, sigma_head,
    feature, view_0, rgb_head (or out_head without view dirs).
    compute_dtype "bfloat16" rounds every Dense input, weight, bias and
    output to bf16 as the reference's bf16 Dense does."""

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Tuple[int, ...] = (4,), posenc_xyz: int = 10,
                 posenc_dir: int = 4, use_viewdirs: bool = True,
                 compute_dtype: str = "float32", cond_dim: int = 0):
        super().__init__()
        self.depth, self.width, self.skips = depth, width, tuple(skips)
        self.cond_dim = cond_dim
        self.posenc_xyz, self.posenc_dir = posenc_xyz, posenc_dir
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = compute_dtype
        cx = 3 * (2 * posenc_xyz + 1) + cond_dim
        ins = []
        for i in range(depth):
            if i == 0:
                ins.append(cx)
            elif (i - 1) in self.skips:
                ins.append(cx + width)
            else:
                ins.append(width)
        self.trunk = nn.ModuleList(nn.Linear(k, width) for k in ins)
        if use_viewdirs:
            cd = 3 * (2 * posenc_dir + 1)
            self.sigma_head = nn.Linear(width, 1)
            self.feature = nn.Linear(width, width)
            self.view_0 = nn.Linear(width + cd, width // 2)
            self.rgb_head = nn.Linear(width // 2, 3)
        else:
            self.out_head = nn.Linear(width, 4)

    def _dense(self, layer: nn.Linear, x):
        if self.compute_dtype == "bfloat16":
            bf = torch.bfloat16
            y = (x.to(bf).float() @ layer.weight.to(bf).float().t()).to(bf)
            return (y.float() + layer.bias.to(bf).float()).to(bf)
        return nn.functional.linear(x, layer.weight, layer.bias)

    def forward(self, x_enc, d_enc=None, cond=None):
        """x_enc (..., Cx), d_enc (..., Cd), cond (..., Cc) → (rgb_raw
        (..., 3), σ_raw)."""
        dt = torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32
        trunk_in = (x_enc if cond is None
                    else torch.cat([x_enc, cond], dim=-1)).to(dt)
        h = trunk_in
        for i, layer in enumerate(self.trunk):
            h = torch.relu(self._dense(layer, h))
            if i in self.skips and i + 1 < self.depth:
                h = torch.cat([trunk_in, h], dim=-1)
        if self.use_viewdirs:
            sigma = self._dense(self.sigma_head, h)[..., 0]
            feat = self._dense(self.feature, h)
            h2 = torch.cat([feat, d_enc.to(dt)], dim=-1)
            h2 = torch.relu(self._dense(self.view_0, h2))
            rgb = self._dense(self.rgb_head, h2)
        else:
            out = self._dense(self.out_head, h)
            rgb, sigma = out[..., :3], out[..., 3]
        return rgb.float(), sigma.float()

    def field(self, pts, viewdirs=None, cond=None):
        """pts (R,S,3), viewdirs (R,3), cond (R,Cc) per ray → (rgb (R,S,3)
        post-sigmoid, σ (R,S) raw)."""
        S = pts.shape[-2]
        x_enc = posenc(pts, self.posenc_xyz)
        d_enc = None
        if self.use_viewdirs:
            d_unit = viewdirs / torch.linalg.norm(viewdirs, dim=-1,
                                                  keepdim=True)
            d_enc = posenc(d_unit, self.posenc_dir)
            d_enc = d_enc[..., None, :].expand(*d_enc.shape[:-1], S,
                                               d_enc.shape[-1])
        if cond is not None:
            cond = cond[..., None, :].expand(*cond.shape[:-1], S,
                                             cond.shape[-1])
        rgb_raw, sigma_raw = self(x_enc, d_enc, cond)
        return torch.sigmoid(rgb_raw), sigma_raw

    def named_dense(self):
        """(reference layer name, nn.Linear) in the reference's order."""
        out = [(f"trunk_{i}", layer) for i, layer in enumerate(self.trunk)]
        heads = (("sigma_head", "feature", "view_0", "rgb_head")
                 if self.use_viewdirs else ("out_head",))
        return out + [(n, getattr(self, n)) for n in heads]

    def to_flax_params(self) -> dict:
        """The reference's parameter tree as numpy: {"params": {name:
        {"kernel": (in, out), "bias": (out,)}}}."""
        return {"params": {
            name: {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                   "bias": layer.bias.detach().cpu().numpy().copy()}
            for name, layer in self.named_dense()}}


def module_field(net: NeRFMLP, pts, viewdirs, cond=None):
    """The module's own plain-torch field in the field-fn convention of
    `posenc_mlp.make_fused_field`: `net.field` under autograd."""
    return net.field(pts, viewdirs, cond)


def _tree_params(tree) -> dict:
    return tree["params"] if "params" in tree else tree


def load_flax_params(tree, compute_dtype: str = "float32",
                     device=None, cond_dim: int = 0) -> NeRFMLP:
    """Build the port's NeRFMLP from the reference's parameter tree (numpy
    arrays from an npz asset or from `jax.device_get`); cond_dim: the width
    of a conditioned field's cond input.

    The architecture is read off the tree: depth from the trunk_i count,
    width and L from trunk_0's kernel less its cond rows, the skip from the
    trunk layer whose kernel has trunk_in + width rows, the view branch
    from view_0. Dense kernels are stored (in, out); nn.Linear.weight is
    (out, in)."""
    p = _tree_params(tree)
    depth = sum(1 for k in p if k.startswith("trunk_"))
    k0 = np.asarray(p["trunk_0"]["kernel"])
    rows, width = k0.shape
    cx = rows - cond_dim
    if cx < 3 or cx % 3 or (cx // 3 - 1) % 2:
        raise ValueError(f"trunk_0 has {rows} input rows: not 3·(2L+1) + "
                         f"{cond_dim} (the cond width)")
    L = (cx // 3 - 1) // 2
    skips = tuple(i - 1 for i in range(1, depth)
                  if np.asarray(p[f"trunk_{i}"]["kernel"]).shape[0] > width)
    use_vd = "view_0" in p
    Ld = 4
    if use_vd:
        cd = np.asarray(p["view_0"]["kernel"]).shape[0] - width
        Ld = (cd // 3 - 1) // 2
    model = NeRFMLP(depth=depth, width=width, skips=skips, posenc_xyz=L,
                    posenc_dir=Ld, use_viewdirs=use_vd,
                    compute_dtype=compute_dtype, cond_dim=cond_dim)
    with torch.no_grad():
        for name, layer in model.named_dense():
            kern = np.asarray(p[name]["kernel"], np.float32)
            if kern.shape != tuple(layer.weight.shape[::-1]):
                raise ValueError(f"{name}: kernel {kern.shape} does not fit "
                                 f"{tuple(layer.weight.shape[::-1])}")
            layer.weight.copy_(torch.tensor(kern.T))
            layer.bias.copy_(torch.tensor(
                np.asarray(p[name]["bias"], np.float32)))
    return model.to(device) if device is not None else model


def cond_width(mcfg) -> int:
    """The cond input's width: the garment code and the per-frame latent."""
    return ((mcfg.condition_dim if mcfg.conditioned else 0)
            + (mcfg.latent_dim if mcfg.n_latents > 0 else 0))


def init_field(mcfg, generator: torch.Generator, device=None,
               cond_dim: int = 0) -> NeRFMLP:
    """A NeRFMLP for ModelConfig `mcfg` (with a cond input of cond_dim)
    initialised as flax's `nn.Dense` initialises the reference: LeCun-normal
    kernels (a normal truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796 so the
    variance is 1/fan_in) and zero biases, f32 parameters. Draws come from
    `generator`, so the distribution is the reference's but not its bits."""
    model = NeRFMLP(depth=mcfg.net_depth, width=mcfg.net_width,
                    skips=tuple(mcfg.skips), posenc_xyz=mcfg.posenc_xyz,
                    posenc_dir=mcfg.posenc_dir,
                    use_viewdirs=mcfg.use_viewdirs,
                    compute_dtype=mcfg.compute_dtype, cond_dim=cond_dim)
    # truncated normal on [-2, 2] has std 0.87962566103423978
    with torch.no_grad():
        for _, layer in model.named_dense():
            std = (1.0 / layer.weight.shape[1]) ** 0.5 / 0.87962566103423978
            w = torch.empty(layer.weight.shape[::-1])      # (in, out)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            layer.weight.copy_(w.t())
            layer.bias.zero_()
    return model.to(device) if device is not None else model
