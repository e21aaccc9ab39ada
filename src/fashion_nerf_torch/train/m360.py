"""mip-NeRF 360's training step (Barron et al., CVPR 2022, arXiv 2111.12077
§4), for configs with `model.ipe_deg > 0`; `train()` picks it once, at
construction, in place of `TrainStep`.

A step, as published, on a batch of `train.batch_rays` rays:
1. the batch's rays drawn from the state's generator, then one uniform
   offset a ray for each of the three resamplings (one draw of (R, 3));
2. two proposal rounds: the intervals resampled with the ray's offset
   (`resample_intervals(..., jitter=)`: quantiles (k + u)/n) from the
   previous round's weights, the first round from the whole of [0, 1]; the
   contracted cone Gaussians, the proposal MLP through K7 under autograd
   (`widefield.wide_field_train`), the interval weights;
3. the NeRF round on `sampling.n_fine` intervals resampled likewise, its
   rgb composited over the background;
4. the losses (`fnt.step.losses`): the Charbonnier data term
   mean √((C − C*)² + ε²) over rays and channels (ε
   `train.charbonnier_eps`); the interlevel loss of each proposal round,
   Σᵢ max(0, wᵢ − bound(ŝ, ŵ, Tᵢ))² / (wᵢ + ε) over the NeRF's intervals
   Tᵢ, averaged over rays (ε float32's machine epsilon, the public
   code's), with the NeRF's (s, w) under stop-gradient, weighted by
   `train.interlevel_weight`; the distortion loss on the NeRF's (s, w),
   Σᵢⱼ wᵢwⱼ|ūᵢ − ūⱼ| + ⅓ Σᵢ wᵢ² Δsᵢ in O(n) by prefix sums, averaged over
   rays, weighted by `train.distortion_weight`. Every interval is resampled
   under stop-gradient, so the proposal MLP learns from the interlevel
   loss alone and the NeRF MLP from the other two;
5. backward, the global gradient norm clipped to `train.grad_max_norm`
   (`fnt.step.clip`), Adam at the warmed-up log-linear rate.

Departures as the render's (core/cones.py): the IPE over the three axes;
no annealing of the weights and no dilation of the intervals.
"""

from __future__ import annotations

import torch

from fashion_nerf_torch.config import Config
from fashion_nerf_torch.core.cones import cone_radius
from fashion_nerf_torch.core.sampling import resample_intervals
from fashion_nerf_torch.data.pipeline import RayDataset, sample_batch
from fashion_nerf_torch.kernels.widefield import wide_field_train
from fashion_nerf_torch.metrics import mse_to_psnr
from fashion_nerf_torch.prng import rand
from fashion_nerf_torch.render.m360 import (PROPOSAL_ROUNDS, _gaussians,
                                            interval_weights)
from fashion_nerf_torch.train.state import (TrainState, clip_gradients,
                                            learning_rate)
from fashion_nerf_torch.trace import span

# the interlevel loss's ε: float32's machine epsilon, as the public code
INTERLEVEL_EPS = float(torch.finfo(torch.float32).eps)


def charbonnier(rgb, target, eps: float):
    """mean √((rgb − target)² + ε²) over rays and channels."""
    return torch.sqrt((rgb - target) ** 2 + eps * eps).mean()


def interlevel_bound(s, s_p, w_p):
    """bound(ŝ, ŵ, Tᵢ): the proposal weights ŵ (R, m) of the intervals of
    ŝ (R, m+1) that overlap each NeRF interval Tᵢ = [sᵢ, sᵢ₊₁] of s
    (R, n+1), as the public code's `inner_outer` sums them: from the last
    proposal edge at or below sᵢ to the first above sᵢ₊₁ → (R, n)."""
    cw = torch.cat([torch.zeros_like(w_p[:, :1]), torch.cumsum(w_p, -1)], -1)
    s_p = s_p.contiguous()
    lo = (torch.searchsorted(s_p, s[:, :-1].contiguous(), right=True) - 1
          ).clamp(min=0)
    hi = torch.searchsorted(s_p, s[:, 1:].contiguous(), right=True).clamp(
        max=w_p.shape[1])
    return cw.gather(1, hi) - cw.gather(1, lo)


def interlevel(s, w, s_p, w_p):
    """One proposal round's interlevel loss: Σᵢ max(0, wᵢ − boundᵢ)² /
    (wᵢ + ε), averaged over rays; (s, w) the NeRF's, taken as constants."""
    s, w = s.detach(), w.detach()
    excess = torch.clamp(w - interlevel_bound(s, s_p, w_p), min=0.0)
    return (excess * excess / (w + INTERLEVEL_EPS)).sum(-1).mean()


def distortion(s, w):
    """Σᵢⱼ wᵢwⱼ |ūᵢ − ūⱼ| + ⅓ Σᵢ wᵢ² (sᵢ₊₁ − sᵢ) with ūᵢ the intervals'
    midpoints, averaged over rays: the double sum as 2 Σᵢ wᵢ (ūᵢ Wᵢ − Uᵢ)
    with Wᵢ, Uᵢ the exclusive prefix sums of w and w·ū (s increasing)."""
    u = 0.5 * (s[:, 1:] + s[:, :-1])

    def before(x):
        return torch.cat([torch.zeros_like(x[:, :1]),
                          torch.cumsum(x, -1)[:, :-1]], -1)

    inter = 2.0 * (w * (u * before(w) - before(w * u))).sum(-1)
    intra = (w * w * (s[:, 1:] - s[:, :-1])).sum(-1) / 3.0
    return (inter + intra).mean()


def render_train(state: TrainState, cfg: Config, batch: dict, jitter,
                 radius: float) -> dict:
    """The rounds of a training step on a batch → rgb (R, 3) with the
    background, the NeRF's s (R, n+1) and w (R, n), and each proposal
    round's (ŝ, ŵ) in "rounds", under autograd."""
    bf16 = cfg.model.compute_dtype == "bfloat16"
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    R = rays_o.shape[0]
    n_p, n_f = cfg.proposal.eval_n, cfg.sampling.n_fine
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    sdist = torch.linspace(0.0, 1.0, 2, device=rays_o.device).expand(R, 2)
    w = torch.ones((R, 1), device=rays_o.device)
    rounds = []
    for r in range(PROPOSAL_ROUNDS):
        with span("fnt.rays.resample"):
            sdist = resample_intervals(sdist, w, n_p,
                                       jitter=jitter[:, r:r + 1]).detach()
        with span("fnt.rays.prop"):
            tdist, mean, var = _gaussians(rays_o, rays_d, radius, sdist, cfg)
            _, sigma = wide_field_train(state.proposal, mean, var, None, n_p,
                                        bf16)
            w_p = interval_weights(sigma.view(R, n_p), tdist, dnorm)
        rounds.append((sdist, w_p))
        w = w_p.detach()
    with span("fnt.rays.resample"):
        sdist = resample_intervals(sdist, w, n_f,
                                   jitter=jitter[:, PROPOSAL_ROUNDS:]).detach()
    with span("fnt.rays.nerf"):
        tdist, mean, var = _gaussians(rays_o, rays_d, radius, sdist, cfg)
        rgb_s, sigma = wide_field_train(state.fine, mean, var,
                                        batch["viewdirs"], n_f, bf16)
        w = interval_weights(sigma.view(R, n_f), tdist, dnorm)
        rgb = torch.sum(w[..., None] * rgb_s.view(R, n_f, 3), dim=1)
        if cfg.render.white_bkgd:
            rgb = rgb + (1.0 - w.sum(dim=1))[:, None]
    return {"rgb": rgb, "s": sdist, "w": w, "rounds": rounds}


def losses(cfg: Config, out: dict, target) -> dict:
    """The step's loss terms and their weighted sum "loss"."""
    t = cfg.train
    data = charbonnier(out["rgb"], target, t.charbonnier_eps)
    inter = sum(interlevel(out["s"], out["w"], s_p, w_p)
                for s_p, w_p in out["rounds"])
    dist = distortion(out["s"], out["w"])
    loss = data + t.interlevel_weight * inter + t.distortion_weight * dist
    return {"loss": loss, "data": data, "interlevel": inter,
            "distortion": dist}


class M360TrainStep:
    """One mip-NeRF 360 training step: step(state, all_rays) → (state,
    metrics), updating state in place (module docstring). streamed:
    all_rays is the batch itself. The spans are TrainStep's, with
    "fnt.step.losses" inside "fnt.step.forward" and "fnt.step.clip"
    between the backward and Adam."""

    def __init__(self, cfg: Config, dataset: RayDataset,
                 streamed: bool = False, garment=None, mesh=None):
        if mesh is not None or garment is not None:
            raise ValueError("mip-NeRF 360 trains in one process, "
                             "unconditioned")
        self.cfg = cfg
        self.n_total = dataset.n_rays
        self.radius = cone_radius(dataset.focal)
        self.streamed = streamed

    def __call__(self, state: TrainState, all_rays: dict):
        cfg = self.cfg
        with span("fnt.step"):
            B = cfg.train.batch_rays
            with span("fnt.step.gather"):
                batch = all_rays if self.streamed else sample_batch(
                    all_rays, state.generator, B, self.n_total)
                jitter = rand((B, PROPOSAL_ROUNDS + 1), state.generator,
                              batch["rays_o"].device)
            with span("fnt.step.forward"):
                out = render_train(state, cfg, batch, jitter, self.radius)
                with span("fnt.step.losses"):
                    terms = losses(cfg, out, batch["rgb"])
            opt = state.optimizer
            params = state.parameters()
            with span("fnt.step.backward"):
                opt.zero_grad(set_to_none=True)
                terms["loss"].backward()
            with span("fnt.step.clip"):
                clip_gradients(cfg, params)
            with span("fnt.step.adam"):
                for group in opt.param_groups:
                    group["lr"] = learning_rate(cfg, state.step)
                opt.step()
            state.step += 1
            mse = torch.mean((out["rgb"].detach() - batch["rgb"]) ** 2)
            metrics = {k: v.detach() for k, v in terms.items()}
            metrics.update(mse_fine=mse, psnr=mse_to_psnr(mse))
            return state, metrics


def state_from_trees(cfg: Config, trees: dict, run_generator,
                     device=None) -> TrainState:
    """A fresh mip-NeRF 360 TrainState holding parameter trees {"proposal",
    "fine"} ({"params": {layer: {"kernel", "bias"}}}, numpy or tensors)."""
    from fashion_nerf_torch.models.mipnerf360 import from_tree, nets_of
    from fashion_nerf_torch.train.state import m360_state
    kw = nets_of(cfg)
    return m360_state(cfg, {k: from_tree(trees[k], device, **kw[k])
                            for k in ("proposal", "fine")}, run_generator)
