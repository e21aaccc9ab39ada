"""TrainState; counterpart of `fashion_nerf.train.state`.

The state holds everything a checkpoint restores: the step, the coarse and
fine nets, for a conditioned config the garment encoder and for a dynamic
one the latent table (both under Adam too), Adam and the step's generator
(the one source of every draw a step makes). The learning rate follows
optax's non-staircase `exponential_decay` read at the pre-update count, as
the reference's `optax.adam(schedule)` does: step k uses
lr_init·(lr_final/lr_init)^(k / lr_decay_steps), times mip-NeRF 360's
warm-up where `train.lr_delay_steps` > 0 (the public code's
m + (1 − m)·sin(½π·clip(k / delay, 0, 1)), m = `lr_delay_mult`). Adam's ε
is `train.adam_eps`. `clip_gradients` scales the gradients to a global
norm of at most `train.grad_max_norm` (the public code's rule).

mip-NeRF 360's state (`model.ipe_deg` > 0) holds its two MipMLPs,
"proposal" and "fine" (models/mipnerf360.py), and no coarse net.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from fashion_nerf_torch.config import Config, is_mipnerf360, train_setting
from fashion_nerf_torch.models.conditioned import GarmentEncoder
from fashion_nerf_torch.models.latents import LatentTable
from fashion_nerf_torch.models.mipnerf360 import MipMLP, init_nets
from fashion_nerf_torch.models.nerf_mlp import (NeRFMLP, cond_width,
                                                init_field, load_flax_params)


@dataclass
class TrainState:
    step: int
    coarse: NeRFMLP
    fine: Optional[NeRFMLP]
    optimizer: torch.optim.Adam     # a dist.mesh.ShardedAdam under tp > 1
    generator: torch.Generator
    encoder: Optional[GarmentEncoder] = None
    latents: Optional[LatentTable] = None
    proposal: Optional[MipMLP] = None

    def nets(self) -> dict:
        """The modules by the reference's params keys: coarse, fine,
        encoder, latents, and mip-NeRF 360's proposal (those the config
        has)."""
        return {k: v for k, v in (("coarse", self.coarse),
                                  ("fine", self.fine),
                                  ("encoder", self.encoder),
                                  ("latents", self.latents),
                                  ("proposal", self.proposal))
                if v is not None}

    def parameters(self):
        return [p for net in self.nets().values() for p in net.parameters()]


def learning_rate(cfg: Config, step: int) -> float:
    t = cfg.train
    lr = t.lr_init * (t.lr_final / t.lr_init) ** (step / t.lr_decay_steps)
    delay = train_setting(cfg, "lr_delay_steps")
    if delay > 0:
        mult = train_setting(cfg, "lr_delay_mult")
        ramp = math.sin(0.5 * math.pi * min(max(step / delay, 0.0), 1.0))
        lr *= mult + (1.0 - mult) * ramp
    return lr


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate(cfg, 0),
                            betas=(0.9, 0.999),
                            eps=train_setting(cfg, "adam_eps"))


def clip_gradients(cfg: Config, params) -> None:
    """Scale the gradients of `params` in place by min(1, max_norm / (ε +
    ‖g‖)), ‖g‖ their global norm and ε float32's machine epsilon, where
    `train.grad_max_norm` > 0."""
    max_norm = train_setting(cfg, "grad_max_norm")
    grads = [p.grad for p in params if p.grad is not None]
    if max_norm <= 0 or not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    mult = torch.clamp(max_norm / (norm + torch.finfo(torch.float32).eps),
                       max=1.0)
    torch._foreach_mul_(grads, mult)


def _state(cfg: Config, nets: dict, run_generator) -> TrainState:
    params = [p for n in nets.values() if n is not None
              for p in n.parameters()]
    return TrainState(step=0, optimizer=make_optimizer(cfg, params),
                      generator=run_generator, **nets)


def m360_state(cfg: Config, nets: dict, run_generator) -> TrainState:
    """A fresh TrainState of mip-NeRF 360's {"proposal", "fine"}
    MipMLPs (Adam over the proposal's parameters, then the NeRF MLP's)."""
    return _state(cfg, {"coarse": None, "proposal": nets["proposal"],
                        "fine": nets["fine"]}, run_generator)


def create_train_state(cfg: Config, init_generator: torch.Generator,
                       run_generator: torch.Generator,
                       device=None) -> TrainState:
    """Fresh nets (coarse; fine when cfg samples a fine pass; the latent
    table and the garment encoder when cfg has them, in the reference's
    init order) drawn from init_generator as flax initialises them; the
    step's draws come from run_generator, which must live on `device`.
    mip-NeRF 360 (`model.ipe_deg` > 0): its two MipMLPs
    (`models.mipnerf360.init_nets`), never a NeRFMLP."""
    m = cfg.model
    if is_mipnerf360(cfg):
        return m360_state(cfg, init_nets(cfg, init_generator, device),
                          run_generator)
    cc = cond_width(m)
    nets = {"coarse": init_field(m, init_generator, device, cc),
            "fine": (init_field(m, init_generator, device, cc)
                     if cfg.sampling.n_fine > 0 else None)}
    if m.n_latents > 0:
        nets["latents"] = LatentTable(m.n_latents, m.latent_dim).init_flax_(
            init_generator).to(device)
    if m.conditioned:
        nets["encoder"] = GarmentEncoder(out_dim=m.condition_dim).init_flax_(
            init_generator).to(device)
    return _state(cfg, nets, run_generator)


def state_from_params(cfg: Config, params: dict,
                      run_generator: torch.Generator,
                      device=None) -> TrainState:
    """A fresh TrainState (step 0, new Adam) holding the reference's
    parameters: params {"coarse", "fine", "encoder", "latents"} as numpy
    trees (`jax.device_get` of a reference state's params, or an npz
    asset). The fields take the config's cond width; the encoder's HWIO
    conv kernels become OIHW; codes/embedding becomes the nn.Embedding."""
    m = cfg.model
    cc = cond_width(m)

    def field(tree):
        return load_flax_params(tree, m.compute_dtype, device, cond_dim=cc)

    nets = {"coarse": field(params["coarse"]),
            "fine": field(params["fine"]) if "fine" in params else None}
    if m.n_latents > 0:
        nets["latents"] = LatentTable(m.n_latents, m.latent_dim).load_flax(
            params["latents"]).to(device)
    if m.conditioned:
        nets["encoder"] = GarmentEncoder(out_dim=m.condition_dim).load_flax(
            params["encoder"]).to(device)
    return _state(cfg, nets, run_generator)
