"""Plain reference of mip-NeRF 360's training steps (Barron et al., CVPR
2022, arXiv 2111.12077 §4), in float32 PyTorch autograd with TF32 off.

It imports nothing of the program. From the parameter trees {"proposal",
"fine"}, the scene's rays, the configuration document's "config" group
(perfbench/configs/mipnerf360_train.json) and the run's seed it follows a
run's first steps, each:

- the draws, from one torch.Generator on the device seeded with the run's
  seed, in the step's order: the batch's ray indices (`train.batch_rays`
  of them, uniform over every ray of the scene), then one uniform offset
  a ray for each of the three resamplings, one (B, 3) draw;
- two proposal rounds: the intervals resampled from the previous round's
  histogram in s (the first round's: the whole of [0, 1]) with the centres
  at the quantiles (k + u)/n of the weights plus a floor of 1e-5 each, u
  the ray's offset for the round, the edges halfway between centres and
  the ends reflected and clamped to [0, 1]; the proposal MLP on the
  contracted cone Gaussians (reference/mipnerf360.py); its weights;
- the NeRF round on `sampling.n_fine` intervals resampled likewise; rgb
  composited over the white background;
- the losses: the Charbonnier term mean √((C − C*)² + ε²) over rays and
  channels; for each proposal round Σᵢ max(0, wᵢ − boundᵢ)² / (wᵢ + ε)
  over the NeRF's intervals, averaged over rays, boundᵢ the sum of the
  proposal weights whose intervals overlap the NeRF interval i (counted
  pair by pair here), (s, w) of the NeRF taken as constants, ε float32's
  machine epsilon; the distortion Σᵢⱼ wᵢwⱼ |ūᵢ − ūⱼ| + ⅓ Σᵢ wᵢ² Δsᵢ on the
  NeRF's (s, w) as the double sum, averaged over rays; weighted 1,
  `train.interlevel_weight`, `train.distortion_weight`;
- the gradients summed over blocks of rays (every loss is a sum over rays
  over the batch's count), scaled to a global norm of at most
  `train.grad_max_norm` (min(1, max / (ε + ‖g‖))), and Adam (β 0.9, 0.999,
  ε `train.adam_eps`) at the rate lr_init·(lr_final/lr_init)^(k/decay)
  times the warm-up m + (1 − m)·sin(½π·clip(k/delay, 0, 1)).

Departures from the paper (as the configuration states them): the IPE
over the three axes, not the public code's polyhedral basis; the
resampling without annealing or dilation; the warm-up's shape, the
interlevel ε and the jitter are the public code's. `quant="fp8"` rounds
both operands of every forward product to float8 e4m3 (the gradient passes
as if unrounded): the control.
"""

from __future__ import annotations

import math

import torch

from . import mipnerf360 as ref

PROPOSAL_ROUNDS = ref.PROPOSAL_ROUNDS
INTERLEVEL_EPS = float(torch.finfo(torch.float32).eps)
BETA1, BETA2 = 0.9, 0.999


class Net:
    """A net of mip-NeRF 360 whose kernels and biases are float32 leaves."""

    def __init__(self, tree, device, quant=None):
        self.mlp = ref.MLP(tree, device)
        self.leaves = {}
        for name, (k, b) in self.mlp.layers.items():
            k = k.clone().requires_grad_(True)
            b = b.clone().requires_grad_(True)
            self.mlp.layers[name] = (k, b)
            self.leaves[name + "/kernel"] = k
            self.leaves[name + "/bias"] = b
        if quant == "fp8":
            mlp = self.mlp

            def dense(name, x):
                k, b = mlp.layers[name]
                qx = x + (ref._fp8(x) - x).detach()
                qk = k + (ref._fp8(k) - k).detach()
                return qx @ qk + b
            mlp._dense = dense


def learning_rate(tr: dict, step: int) -> float:
    lr = tr["lr_init"] * (tr["lr_final"] / tr["lr_init"]) ** (
        step / tr["lr_decay_steps"])
    if tr["lr_delay_steps"] > 0:
        m = tr["lr_delay_mult"]
        lr *= m + (1.0 - m) * math.sin(
            0.5 * math.pi * min(max(step / tr["lr_delay_steps"], 0.0), 1.0))
    return lr


def resample(sdist, w, n: int, u):
    """The histogram (edges sdist (R, B+1), masses w (R, B)) resampled to
    n intervals with the centres at the quantiles (k + u)/n, u (R, 1) →
    (R, n+1) edges."""
    p = w + ref.RESAMPLE_EPS
    cdf = torch.cumsum(p / p.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    q = ((torch.arange(n, dtype=torch.float32, device=w.device) + u) / n
         ).contiguous()
    hi = torch.searchsorted(cdf.contiguous(), q, right=True)
    lo = (hi - 1).clamp(min=0)
    hi = hi.clamp(max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    s0, s1 = sdist.gather(1, lo), sdist.gather(1, hi)
    span = c1 - c0
    frac = (q - c0) / torch.where(span < ref.RESAMPLE_EPS,
                                  torch.ones_like(span), span)
    centres = s0 + frac * (s1 - s0)
    mid = (centres[:, 1:] + centres[:, :-1]) / 2.0
    first = torch.clamp(2.0 * centres[:, :1] - mid[:, :1], min=0.0)
    last = torch.clamp(2.0 * centres[:, -1:] - mid[:, -1:], max=1.0)
    return torch.cat([first, mid, last], dim=-1)


def overlap_bound(s, s_p, w_p):
    """For each NeRF interval [sᵢ, sᵢ₊₁], the sum of the proposal weights
    of the intervals [ŝⱼ, ŝⱼ₊₁] with ŝⱼ₊₁ > sᵢ and ŝⱼ ≤ sᵢ₊₁, pair by
    pair → (R, n)."""
    over = ((s_p[:, None, 1:] > s[:, :-1, None])
            & (s_p[:, None, :-1] <= s[:, 1:, None]))
    return (over * w_p[:, None, :]).sum(-1)


def distortion_sum(s, w):
    """Per ray: Σᵢⱼ wᵢwⱼ |ūᵢ − ūⱼ| + ⅓ Σᵢ wᵢ² Δsᵢ, the double sum as
    written."""
    u = 0.5 * (s[:, 1:] + s[:, :-1])
    inter = (w[:, :, None] * w[:, None, :]
             * (u[:, :, None] - u[:, None, :]).abs()).sum((1, 2))
    return inter + (w * w * (s[:, 1:] - s[:, :-1])).sum(-1) / 3.0


def _block_loss(cfg: dict, nets: dict, rays: dict, idx, jitter, radius,
                B: int):
    """The batch's loss terms over the rays idx, as their share of the
    batch's means → (total, {"data", "interlevel", "distortion"})."""
    tr, n_p, n_f = cfg["train"], cfg["proposal"]["eval_n"], \
        cfg["sampling"]["n_fine"]
    o, d, vd, target = (rays["rays_o"][idx], rays["rays_d"][idx],
                        rays["viewdirs"][idx], rays["rgb"][idx])
    R = o.shape[0]
    sdist = torch.tensor([0.0, 1.0], device=o.device).expand(R, 2)
    w = torch.ones((R, 1), device=o.device)
    rounds = []
    for r in range(PROPOSAL_ROUNDS):
        with torch.no_grad():
            sdist = resample(sdist, w, n_p, jitter[:, r:r + 1])
        w_p, _ = ref._eval(cfg, nets["proposal"].mlp, o, d, sdist, radius)
        rounds.append((sdist, w_p))
        w = w_p.detach()
    with torch.no_grad():
        sdist = resample(sdist, w, n_f, jitter[:, PROPOSAL_ROUNDS:])
    enc = ref.dir_encoding(vd, cfg["model"]["posenc_dir"])
    w, rgb_s = ref._eval(cfg, nets["fine"].mlp, o, d, sdist, radius, enc)
    rgb = (w[..., None] * rgb_s).sum(1)
    if cfg["render"]["white_bkgd"]:
        rgb = rgb + (1.0 - w.sum(1))[:, None]
    eps = tr["charbonnier_eps"]
    data = torch.sqrt((rgb - target) ** 2 + eps * eps).sum() / (3 * B)
    ws, ss = w.detach(), sdist
    inter = 0.0
    for s_p, w_p in rounds:
        excess = torch.clamp(ws - overlap_bound(ss, s_p, w_p), min=0.0)
        inter = inter + (excess ** 2 / (ws + INTERLEVEL_EPS)).sum() / B
    dist = distortion_sum(sdist, w).sum() / B
    total = (data + tr["interlevel_weight"] * inter
             + tr["distortion_weight"] * dist)
    return total, {"data": data, "interlevel": inter, "distortion": dist}


def follow(cfg: dict, trees: dict, rays: dict, focal: float, seed: int,
           start: int, n_steps: int, device, quant=None,
           rays_per_block: int = 2048) -> dict:
    """Steps start … start + n_steps − 1 → dict losses [per step], grad
    {leaf: the first step's clipped gradient}, delta {leaf: the
    parameters' change over the steps}; leaves "<net>/<layer>/kernel" and
    "…/bias". rays: {"rays_o", "rays_d", "viewdirs", "rgb"} of every ray of
    the scene."""
    tr = cfg["train"]
    nets = {k: Net(trees[k], device, quant) for k in ("proposal", "fine")}
    leaves = {f"{k}/{n}": v for k, net in nets.items()
              for n, v in net.leaves.items()}
    start_vals = {k: v.detach().clone() for k, v in leaves.items()}
    m1 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    m2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    n_total, B = rays["rays_o"].shape[0], tr["batch_rays"]
    radius = 2.0 / math.sqrt(12.0) / focal
    out = {"losses": []}
    with ref.exact_f32():
        for t_step, i in enumerate(range(start, start + n_steps), 1):
            idx = torch.randint(0, n_total, (B,), generator=gen,
                                device=device)
            jitter = torch.rand((B, PROPOSAL_ROUNDS + 1), generator=gen,
                                device=device)
            loss = 0.0
            grads = [torch.zeros_like(v) for v in leaves.values()]
            for rows in torch.arange(B, device=device).split(rays_per_block):
                part, _ = _block_loss(cfg, nets, rays, idx[rows],
                                      jitter[rows], radius, B)
                loss += float(part.detach())
                for g, p in zip(grads, torch.autograd.grad(
                        part, list(leaves.values()), allow_unused=True)):
                    if p is not None:
                        g += p
            norm = math.sqrt(sum(float((g * g).sum()) for g in grads))
            if tr["grad_max_norm"] > 0:
                mult = min(1.0, tr["grad_max_norm"] / (INTERLEVEL_EPS + norm))
                grads = [g * mult for g in grads]
            lr = learning_rate(tr, i)
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    if t_step == 1:
                        out.setdefault("grad", {})[k] = g.clone()
                    m1[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                    m2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    mh = m1[k] / (1 - BETA1 ** t_step)
                    vh = m2[k] / (1 - BETA2 ** t_step)
                    p.sub_(lr * mh / (vh.sqrt() + tr["adam_eps"]))
            out["losses"].append(loss)
    out["delta"] = {k: v.detach() - start_vals[k] for k, v in leaves.items()}
    return out


def scene_rays(images, poses, focal: float, device) -> dict:
    """Every pixel's ray of the posed views, view-major and row-major
    (reference/mipnerf360.camera_rays), world space."""
    N, H, W, _ = images.shape
    os_, ds_ = [], []
    for p in poses:
        o, d = ref.camera_rays(H, W, focal, p, device)
        os_.append(o)
        ds_.append(d)
    o, d = torch.cat(os_), torch.cat(ds_)
    return {"rays_o": o, "rays_d": d, "viewdirs": d,
            "rgb": images.reshape(-1, 3).float().to(device)}
