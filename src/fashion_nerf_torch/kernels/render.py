"""Fused volume render (kernel K5, csrc/volrend.cu) and its plain version.

Counterpart of `fashion_nerf.kernels.render_pallas.fused_render_rays`: the
dense renderer's compositing when no occupancy culling is on (the trainer's
evaluation of the held-out view). The math is the reference kernel's, not
`core.volrend.volume_render`'s: log(1−α) = max(−σδ, −23.025851) summed by
an exclusive scan, w = α·exp(log T), where volume_render takes
cumprod(1 − α + 1e-10). The two differ in the last bits.

Forward only, as in the reference: the backward of `fused_render_rays` is
plain autograd through `core.volrend.volume_render` on the same inputs.
"""

from __future__ import annotations

import torch

from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.volrend import volume_render
from fashion_nerf_torch.kernels.sigmamarch import _density
from fashion_nerf_torch.prng import randn
from fashion_nerf_torch.trace import span

_INF_DIST = 1e10
_LOG_FLOOR = -23.025851


def volrend_plain(rgb, sigma, t_vals, dnorm, white_bkgd: bool,
                  softplus: bool = False):
    """Plain version of K5: rgb (R,S,3), sigma/t_vals (R,S), dnorm (R,) →
    (rgb (R,3), depth (R,), acc (R,), weights (R,S))."""
    dists = torch.cat([t_vals[:, 1:] - t_vals[:, :-1],
                       torch.full_like(t_vals[:, :1], _INF_DIST)], dim=1)
    x = _density(sigma, softplus) * (dists * dnorm[:, None])
    alpha = 1.0 - torch.exp(-x)
    log_om = torch.clamp(-x, min=_LOG_FLOOR)
    log_t = torch.cat([torch.zeros_like(log_om[:, :1]),
                       torch.cumsum(log_om, dim=1)[:, :-1]], dim=1)
    weights = alpha * torch.exp(log_t)
    acc = weights.sum(1)
    rgb_map = (weights[..., None] * rgb).sum(1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    return rgb_map, (weights * t_vals).sum(1), acc, weights


def volrend(rgb, sigma, t_vals, dnorm, white_bkgd: bool,
            softplus: bool = False):
    """Fused volume render → (rgb, depth, acc, weights). CPU tensors: plain
    version; CUDA tensors: kernel K5."""
    dev = K.on_cuda(rgb, sigma, t_vals, dnorm)
    if dev is None:
        return volrend_plain(rgb, sigma, t_vals, dnorm, white_bkgd, softplus)
    with span("fnt.kernel.volrend"):
        R, S = sigma.shape
        K.check(rgb, "rgb", torch.float32, (R, S, 3))
        K.check(sigma, "sigma", torch.float32, (R, S))
        K.check(t_vals, "t_vals", torch.float32, (R, S))
        K.check(dnorm, "dnorm", torch.float32, (R,))
        # one allocation for the four outputs; the results are views of it
        buf = torch.empty((R * (S + 5),), device=dev)
        weights, rgb_map, depth, acc = (
            v.view(shape) for v, shape in zip(
                buf.split((R * S, 3 * R, R, R)), ((R, S), (R, 3), (R,), (R,))))
        if R == 0:
            return rgb_map, depth, acc, weights
        ptrs = [x.data_ptr() for x in (rgb, sigma, t_vals, dnorm, rgb_map,
                                       depth, acc, weights)]
        code = K.library().fnt_volrend(*ptrs, R, S, int(white_bkgd),
                                       int(softplus), *K.launch_args(dev))
        K.raise_on_error(code, "fnt_volrend")
        K.LAUNCHES["volrend"] += 1
        return rgb_map, depth, acc, weights


class _FusedRender(torch.autograd.Function):
    """K5 (or its plain version) forward; backward by autograd through
    `volume_render`, as the reference's custom VJP does."""

    @staticmethod
    def forward(ctx, rgb, sigma, t_vals, rays_d, white_bkgd, softplus,
                plain):
        dnorm = torch.linalg.norm(rays_d, dim=-1)
        fn = volrend_plain if plain else volrend
        out = fn(rgb.contiguous(), sigma.contiguous(), t_vals.contiguous(),
                 dnorm.contiguous(), white_bkgd, softplus)
        ctx.save_for_backward(rgb, sigma, t_vals, rays_d)
        ctx.white_bkgd, ctx.softplus = white_bkgd, softplus
        return out

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc, g_w):
        inputs = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = volume_render(*inputs, white_bkgd=ctx.white_bkgd,
                                sigma_activation=("softplus" if ctx.softplus
                                                  else "relu"))
            grads = torch.autograd.grad(
                [out["rgb"], out["depth"], out["acc"], out["weights"]],
                inputs, [g_rgb, g_depth, g_acc, g_w], allow_unused=True)
        return (*grads, None, None, None)


def fused_render_rays(rgb, sigma, t_vals, rays_d, white_bkgd: bool = False,
                      raw_noise_std: float = 0.0, generator=None,
                      sigma_activation: str = "relu", plain: bool = False):
    """Drop-in twin of `core.volrend.volume_render` through K5 (same
    returns). σ noise, when asked for, is drawn from `generator` before the
    kernel. plain=True takes the plain version on any device."""
    if raw_noise_std > 0.0:
        sigma = sigma + randn(sigma.shape, generator,
                              sigma.device) * raw_noise_std
    rgb_map, depth, acc, weights = _FusedRender.apply(
        rgb, sigma, t_vals, rays_d, white_bkgd,
        sigma_activation == "softplus", plain)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return {"rgb": rgb_map, "depth": depth, "acc": acc, "weights": weights,
            "disp": disp}
