"""Plain reference of mip-NeRF 360's render (Barron et al., "Mip-NeRF 360:
Unbounded Anti-Aliased Neural Radiance Fields", CVPR 2022, arXiv
2111.12077), in float32 PyTorch.

It imports nothing of the program. It reads the configuration document's
"config" group (perfbench/configs/mipnerf360.json) and parameter trees
{"proposal", "fine"} in the layout {"params": {layer: {"kernel": (in, out),
"bias": (out,)}}} (tensors or numpy arrays).

The equations, at evaluation:
- rays: pinhole rays of every pixel (the camera looks down −z, +y up, d not
  normalised); cone radius ṙ = 2/√12 · (1 / focal), the distance between
  neighbouring pixels' directions;
- distances: s in [0, 1] mapped by g(x) = 1/x: t = 1 / (s/far + (1−s)/near);
- each interval [t0, t1] a conical frustum turned into a Gaussian by
  mip-NeRF's eqs. 7-8 (ICCV 2021): mean o + d·t_μ, covariance
  σ_t² d dᵀ + σ_r² (I − d dᵀ/‖d‖²), formed as a 3 × 3 matrix;
- contraction: contract(x) = x for ‖x‖ ≤ 1, (2 − 1/‖x‖) x/‖x‖ beyond; the
  mean contracted, the covariance J Σ Jᵀ with the Jacobian written as its
  radial (1/r²) and tangential ((2 − 1/r)/r) parts, its diagonal kept;
- integrated positional encoding over the three axes (mip-NeRF's form):
  [sin(2ˡ μ) exp(−½ 4ˡ σ²) (l = 0 … L−1, axes innermost), the same with
  cos], no identity; the cos as sin(2ˡ μ + π/2), as the public code writes
  it (so is the view encoding's);
- the proposal MLP (σ only) on `proposal.eval_n` intervals evenly spaced in
  s, its weights' histogram in s resampled (centres at the quantiles
  (k + ½)/n of the weights plus a floor of 1e-5 each, edges halfway between
  centres, the ends reflected and clamped to [0, 1]) to `proposal.eval_n`
  intervals, the proposal again, a resample to `sampling.n_fine`;
- the NeRF MLP: ReLU trunk with the IPE joined again after each skip layer
  as [h, γ], σ = softplus(raw − 1), a bottleneck (no activation) joined
  with the view encoding [d̂, sin(2ˡ d̂), cos(2ˡ d̂)] (l < `model.posenc_dir`),
  one ReLU view layer, rgb = sigmoid · (1 + 2·0.001) − 0.001;
- compositing: αᵢ = 1 − exp(−σᵢ Δtᵢ ‖d‖), wᵢ = αᵢ Πⱼ<ᵢ (1 − αⱼ),
  rgb = Σ w c + (1 − Σ w) × background (1 with `render.white_bkgd`).
Departures from the published model (as the configuration states): the
IPE is over the three axes, not the public code's polyhedral basis; the
resampling has no dilation or annealing (evaluation); training and its
losses are not here.

Every matrix product is float32 with TF32 off. `quant="fp8"` rounds both
operands of every product to float8 e4m3 with a scale per tensor: the
control that has to fail the comparison.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

FP8_MAX = 448.0
RGB_PADDING = 0.001
DENSITY_BIAS = -1.0
PROPOSAL_ROUNDS = 2
RESAMPLE_EPS = 1e-5


@contextmanager
def exact_f32():
    """Float32 matrix products without TF32 for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x):
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class MLP:
    """One net of a parameter tree: the trunk (its skip layers read off the
    kernels' rows), σ, and with a view branch the bottleneck, the view
    layer and rgb."""

    def __init__(self, tree, device, quant=None):
        p = tree["params"] if "params" in tree else tree

        def t(a):
            return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a),
                                   dtype=torch.float32, device=device)

        self.layers = {k: (t(v["kernel"]), t(v["bias"])) for k, v in p.items()}
        self.depth = sum(1 for k in p if k.startswith("trunk_"))
        self.width = self.layers["trunk_0"][0].shape[1]
        self.skips = {i - 1 for i in range(1, self.depth)
                      if self.layers[f"trunk_{i}"][0].shape[0] > self.width}
        self.has_vd = "view_0" in self.layers
        self.quant = quant

    def _dense(self, name, x):
        k, b = self.layers[name]
        if self.quant == "fp8":
            return _fp8(x) @ _fp8(k) + b
        return x @ k + b

    def __call__(self, feat, dir_enc=None):
        """IPE features (n, 6L), view encodings (n, Cd) → (rgb (n, 3) or
        None, raw σ (n,))."""
        h = feat
        for i in range(self.depth):
            h = torch.relu(self._dense(f"trunk_{i}", h))
            if i in self.skips and i + 1 < self.depth:
                h = torch.cat([h, feat], dim=-1)
        sigma = self._dense("sigma_head", h)[:, 0]
        if not self.has_vd:
            return None, sigma
        bn = self._dense("feature", h)
        v = torch.relu(self._dense("view_0", torch.cat([bn, dir_enc], -1)))
        rgb = torch.sigmoid(self._dense("rgb_head", v))
        return rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING, sigma


def camera_rays(H: int, W: int, focal: float, c2w, device):
    """Pinhole rays of every pixel, row-major → (o, d) (H·W, 3)."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing="ij")
    dirs = torch.stack([(ii - W * 0.5) / focal, -(jj - H * 0.5) / focal,
                        -torch.ones_like(ii)], dim=-1).reshape(-1, 3)
    rot = c2w[:3, :3]
    d = (dirs[:, 0:1] * rot[:, 0] + dirs[:, 1:2] * rot[:, 1]
         + dirs[:, 2:3] * rot[:, 2])
    return c2w[:3, 3].expand(d.shape), d


def s_to_t(s, near: float, far: float):
    return 1.0 / (s / far + (1.0 - s) / near)


def frustum_gaussian(o, d, t0, t1, radius: float):
    """Intervals (R, S) of rays (R, 3) → mean (R, S, 3), covariance
    (R, S, 3, 3)."""
    mu, hw = (t0 + t1) / 2.0, (t1 - t0) / 2.0
    den = 3.0 * mu ** 2 + hw ** 2
    t_mean = mu + 2.0 * mu * hw ** 2 / den
    t_var = hw ** 2 / 3.0 - (4.0 / 15.0) * (hw ** 4 * (12.0 * mu ** 2
                                                       - hw ** 2) / den ** 2)
    r_var = radius ** 2 * (mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
                           - (4.0 / 15.0) * hw ** 4 / den)
    mean = o[:, None, :] + d[:, None, :] * t_mean[..., None]
    dd = torch.clamp(torch.sum(d * d, dim=-1), min=1e-10)
    outer = d[:, :, None] * d[:, None, :]
    null = torch.eye(3, device=d.device) - outer / dd[:, None, None]
    cov = (t_var[..., None, None] * outer[:, None]
           + r_var[..., None, None] * null[:, None])
    return mean, cov


def contract_gaussian(mean, cov):
    """The contraction of Gaussians → (mean', diag(J Σ Jᵀ))."""
    r = torch.linalg.norm(mean, dim=-1)[..., None, None]
    rr = torch.clamp(r, min=1.0)
    u = mean[..., :, None] / rr
    radial = u * u.transpose(-1, -2)
    eye = torch.eye(3, device=mean.device)
    J = (2.0 - 1.0 / rr) / rr * (eye - radial) + radial / rr ** 2
    J = torch.where(r <= 1.0, eye.expand_as(J), J)
    diag = torch.sum((J @ cov) * J, dim=-1)
    m = torch.where(r[..., 0] <= 1.0, mean,
                    (2.0 - 1.0 / rr[..., 0]) * mean / rr[..., 0])
    return m, diag


def ipe(mean, var, L: int):
    scales = 2.0 ** torch.arange(L, dtype=torch.float32, device=mean.device)
    shape = mean.shape[:-1] + (3 * L,)
    sm = (mean[..., None, :] * scales[:, None]).reshape(shape)
    sv = (var[..., None, :] * (scales ** 2)[:, None]).reshape(shape)
    att = torch.exp(-0.5 * sv)
    return torch.cat([torch.sin(sm) * att, torch.sin(sm + 0.5 * math.pi)
                      * att], dim=-1)


def dir_encoding(viewdirs, L: int):
    d = viewdirs / torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
    scales = 2.0 ** torch.arange(L, dtype=torch.float32, device=d.device)
    sd = (d[..., None, :] * scales[:, None]).reshape(d.shape[0], 3 * L)
    return torch.cat([d, torch.sin(sd), torch.sin(sd + 0.5 * math.pi)],
                     dim=-1)


def composite_weights(sigma_raw, tdist, dnorm):
    density = torch.nn.functional.softplus(sigma_raw + DENSITY_BIAS)
    dd = density * (tdist[:, 1:] - tdist[:, :-1]) * dnorm
    alpha = 1.0 - torch.exp(-dd)
    excl = torch.cumsum(dd, dim=1) - dd
    return alpha * torch.exp(-excl)


def resample(sdist, w, n: int):
    """The histogram (edges sdist (R, B+1), masses w (R, B)) resampled to n
    intervals (module docstring) → (R, n+1) edges."""
    p = w + RESAMPLE_EPS
    cdf = torch.cumsum(p / p.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    u = ((torch.arange(n, dtype=torch.float32, device=w.device) + 0.5) / n
         ).expand(w.shape[0], n).contiguous()
    hi = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = (hi - 1).clamp(min=0)
    hi = hi.clamp(max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    s0, s1 = sdist.gather(1, lo), sdist.gather(1, hi)
    span = c1 - c0
    frac = (u - c0) / torch.where(span < RESAMPLE_EPS,
                                  torch.ones_like(span), span)
    centres = s0 + frac * (s1 - s0)
    mid = (centres[:, 1:] + centres[:, :-1]) / 2.0
    first = torch.clamp(2.0 * centres[:, :1] - mid[:, :1], min=0.0)
    last = torch.clamp(2.0 * centres[:, -1:] - mid[:, -1:], max=1.0)
    return torch.cat([first, mid, last], dim=-1)


def _eval(cfg: dict, net: MLP, o, d, sdist, radius, dir_enc=None):
    r = cfg["render"]
    tdist = s_to_t(sdist, r["near"], r["far"])
    mean, cov = frustum_gaussian(o, d, tdist[:, :-1], tdist[:, 1:], radius)
    mean, var = contract_gaussian(mean, cov)
    R, S = tdist.shape[0], tdist.shape[1] - 1
    feat = ipe(mean, var, cfg["model"]["ipe_deg"]).reshape(R * S, -1)
    rows = None if dir_enc is None else dir_enc.repeat_interleave(S, dim=0)
    rgb, sigma = net(feat, rows)
    dnorm = torch.linalg.norm(d, dim=-1, keepdim=True)
    w = composite_weights(sigma.view(R, S), tdist, dnorm)
    return w, (None if rgb is None else rgb.view(R, S, 3))


def render_rays(cfg: dict, nets: dict, o, d, viewdirs, radius: float):
    """Rays (R, 3) → rgb (R, 3) with the background, acc (R,)."""
    n_p, n_f = cfg["proposal"]["eval_n"], cfg["sampling"]["n_fine"]
    R = o.shape[0]
    sdist = torch.linspace(0.0, 1.0, n_p + 1, device=o.device).expand(
        R, n_p + 1)
    for k in range(PROPOSAL_ROUNDS):
        w, _ = _eval(cfg, nets["proposal"], o, d, sdist, radius)
        sdist = resample(sdist, w, n_p if k + 1 < PROPOSAL_ROUNDS else n_f)
    enc = dir_encoding(viewdirs, cfg["model"]["posenc_dir"])
    w, rgb = _eval(cfg, nets["fine"], o, d, sdist, radius, enc)
    acc = w.sum(dim=1)
    out = torch.sum(w[..., None] * rgb, dim=1)
    if cfg["render"]["white_bkgd"]:
        out = out + (1.0 - acc[:, None])
    return out, acc


def render_frame(cfg: dict, nets: dict, H: int, W: int, focal: float, c2w,
                 device, block: int = 16384):
    """One H×W frame in blocks of rays → dict rgb (H, W, 3), acc (H, W) on
    the device."""
    o, d = camera_rays(H, W, focal, c2w, device)
    radius = 2.0 / math.sqrt(12.0) / focal
    rgbs, accs = [], []
    with exact_f32(), torch.no_grad():
        for s in range(0, o.shape[0], block):
            c, a = render_rays(cfg, nets, o[s:s + block], d[s:s + block],
                               d[s:s + block], radius)
            rgbs.append(c)
            accs.append(a)
    return {"rgb": torch.cat(rgbs).reshape(H, W, 3),
            "acc": torch.cat(accs).reshape(H, W)}


def build(trees: dict, device, quant=None) -> dict:
    """{"proposal", "fine"} MLPs of the parameter trees."""
    return {k: MLP(v, device, quant) for k, v in trees.items()}
