"""TrainState; counterpart of `fashion_nerf.train.state`.

The state holds everything a checkpoint restores: the step, the coarse and
fine nets, for a conditioned config the garment encoder and for a dynamic
one the latent table (both under Adam too), Adam and the step's generator
(the one source of every draw a step makes). The learning rate follows
optax's non-staircase `exponential_decay` read at the pre-update count, as
the reference's `optax.adam(schedule)` does: step k uses
lr_init·(lr_final/lr_init)^(k / lr_decay_steps).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from fashion_nerf_torch.config import Config
from fashion_nerf_torch.models.conditioned import GarmentEncoder
from fashion_nerf_torch.models.latents import LatentTable
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

    def nets(self) -> dict:
        """The modules by the reference's params keys: coarse, fine,
        encoder, latents (those the config has)."""
        return {k: v for k, v in (("coarse", self.coarse),
                                  ("fine", self.fine),
                                  ("encoder", self.encoder),
                                  ("latents", self.latents))
                if v is not None}

    def parameters(self):
        return [p for net in self.nets().values() for p in net.parameters()]


def learning_rate(cfg: Config, step: int) -> float:
    t = cfg.train
    return t.lr_init * (t.lr_final / t.lr_init) ** (step / t.lr_decay_steps)


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate(cfg, 0),
                            betas=(0.9, 0.999), eps=1e-8)


def _state(cfg: Config, nets: dict, run_generator) -> TrainState:
    params = [p for n in nets.values() if n is not None
              for p in n.parameters()]
    return TrainState(step=0, optimizer=make_optimizer(cfg, params),
                      generator=run_generator, **nets)


def create_train_state(cfg: Config, init_generator: torch.Generator,
                       run_generator: torch.Generator,
                       device=None) -> TrainState:
    """Fresh nets (coarse; fine when cfg samples a fine pass; the latent
    table and the garment encoder when cfg has them, in the reference's
    init order) drawn from init_generator as flax initialises them; the
    step's draws come from run_generator, which must live on `device`."""
    m = cfg.model
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
