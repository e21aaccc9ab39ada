"""Cone Gaussians, the contraction and the integrated positional encoding
of mip-NeRF 360 (Barron et al., CVPR 2022, arXiv 2111.12077; the frustum
Gaussians are mip-NeRF's, ICCV 2021, eqs. 7-8).

A sample interval [t0, t1] of a ray o + t·d is a conical frustum whose
radius grows as ṙ·t (ṙ = 2/√12 times the pixel footprint along d). It is
turned into a Gaussian with mean o + d·t_μ and covariance

    Σ = σ_t² d dᵀ + σ_r² (I − d dᵀ / ‖d‖²),

then contracted: contract(x) = x for ‖x‖ ≤ 1, (2 − 1/‖x‖) x/‖x‖ beyond,
with Σ' = J Σ Jᵀ and J the Jacobian of contract at the mean. Outside the
unit ball, with r = ‖x‖ and u = x/r,

    J = s I + c u uᵀ,   s = (2r − 1)/r²,   c = 2(1 − r)/r²,

so diag Σ' has the closed form a (J d)ᵢ² + b (J²)ᵢᵢ with a = σ_t² − σ_r²/‖d‖²,
b = σ_r², J d = s d + c u (u·d) and (J²)ᵢᵢ = s² + (2sc + c²) uᵢ²: no 3×3
matrix is formed. The encoding is over the three axes (mip-NeRF's form, not
the public code's projection onto a polyhedral basis):

    γ = [sin(2ˡ μ') exp(−½ 4ˡ diag Σ')  (l = 0 … L−1, axes innermost),
         cos(…) the same],                            6L features.

Samples are spaced in s = (g(t) − g(t_n)) / (g(t_f) − g(t_n)) with
g(x) = 1/x (`s_to_t`).
"""

from __future__ import annotations

import math

import torch

# ṙ per unit of the pixel footprint: a disc of the pixel's area variance
RADIUS_SCALE = 2.0 / math.sqrt(12.0)
_HALF_PI = 0.5 * math.pi


def s_to_t(s, near: float, far: float):
    """Distances of normalised s in [0, 1] under g(x) = 1/x."""
    return 1.0 / (s / far + (1.0 - s) / near)


def cone_radius(focal: float) -> float:
    """ṙ of a pinhole camera: 2/√12 times the distance between the
    directions (x/f, y/f, −1) of neighbouring pixels, 1/f."""
    return RADIUS_SCALE / focal


def frustum_moments(t0, t1, radius):
    """The frustum [t0, t1] of radius·t → (t_mean, t_var, r_var), in
    mip-NeRF's stable form (its eq. 7 written about the midpoint and the
    half-width)."""
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    mu2, hw2 = mu * mu, hw * hw
    den = 3.0 * mu2 + hw2
    t_mean = mu + 2.0 * mu * hw2 / den
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (hw2 * hw2 * (12.0 * mu2 - hw2)
                                        / (den * den))
    r_var = radius * radius * (mu2 / 4.0 + (5.0 / 12.0) * hw2
                               - (4.0 / 15.0) * hw2 * hw2 / den)
    return t_mean, t_var, r_var


def contract(x):
    """mip-NeRF 360's contraction of points (..., 3)."""
    r = torch.linalg.norm(x, dim=-1, keepdim=True)
    r_safe = torch.clamp(r, min=1.0)
    return torch.where(r <= 1.0, x, (2.0 - 1.0 / r_safe) * x / r_safe)


def contract_jacobian(x):
    """J of `contract` at points (..., 3) → (..., 3, 3)."""
    r = torch.linalg.norm(x, dim=-1, keepdim=True)
    r_safe = torch.clamp(r, min=1.0)
    u = x / r_safe
    s = (2.0 * r_safe - 1.0) / (r_safe * r_safe)
    c = 2.0 * (1.0 - r_safe) / (r_safe * r_safe)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    J = s[..., None] * eye + c[..., None] * u[..., :, None] * u[..., None, :]
    return torch.where((r <= 1.0)[..., None], eye.expand_as(J), J)


def cone_gaussians(rays_o, rays_d, radius, tdist):
    """The contracted Gaussians of every interval of every ray: rays (R, 3),
    radius ṙ (scalar or (R, 1)), interval edges tdist (R, S+1) → mean
    μ' (R, S, 3), diag Σ' (R, S, 3), both f32."""
    t_mean, t_var, r_var = frustum_moments(tdist[:, :-1], tdist[:, 1:],
                                           radius)
    d = rays_d[:, None, :]
    mean = rays_o[:, None, :] + d * t_mean[..., None]
    dd = torch.sum(rays_d * rays_d, dim=-1, keepdim=True).clamp(min=1e-10)
    a = (t_var - r_var / dd)[..., None]
    b = r_var[..., None]
    r = torch.linalg.norm(mean, dim=-1, keepdim=True)
    r_safe = torch.clamp(r, min=1.0)
    u = mean / r_safe
    s = (2.0 * r_safe - 1.0) / (r_safe * r_safe)
    c = 2.0 * (1.0 - r_safe) / (r_safe * r_safe)
    jd = s * d + c * u * torch.sum(u * d, dim=-1, keepdim=True)
    jj = s * s + (2.0 * s * c + c * c) * u * u
    inside = r <= 1.0
    var = torch.where(inside, a * d * d + b, a * jd * jd + b * jj)
    mean = torch.where(inside, mean, (2.0 - 1.0 / r_safe) * u)
    return mean, var


def ipe(mean, var, L: int):
    """Integrated positional encoding of Gaussians (..., 3) → (..., 6L) f32
    (module docstring; the cos half is sin at the phase + π/2)."""
    scales = 2.0 ** torch.arange(L, dtype=torch.float32, device=mean.device)
    shape = mean.shape[:-1] + (3 * L,)
    ph = (mean[..., None, :] * scales[:, None]).reshape(shape)
    att = torch.exp(-0.5 * (var[..., None, :]
                            * (scales * scales)[:, None]).reshape(shape))
    return torch.cat([torch.sin(ph) * att, torch.sin(ph + _HALF_PI) * att],
                     dim=-1)


def viewdir_encoding(viewdirs, L: int):
    """[d̂, sin(2ˡ d̂) (l-major), cos(…)] of the unit view direction → (R,
    3 + 6L), mip-NeRF 360's direction encoding with the identity first."""
    d = viewdirs / torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
    scales = 2.0 ** torch.arange(L, dtype=torch.float32, device=d.device)
    ph = (d[..., None, :] * scales[:, None]).reshape(d.shape[:-1] + (3 * L,))
    return torch.cat([d, torch.sin(ph), torch.sin(ph + _HALF_PI)], dim=-1)
