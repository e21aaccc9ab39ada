"""TrainState; counterpart of `fashion_nerf.train.state`.

The state holds everything a checkpoint restores: the step, the coarse and
fine nets, Adam and the step's generator (the one source of every draw a
step makes). The learning rate follows optax's non-staircase
`exponential_decay` read at the pre-update count, as the reference's
`optax.adam(schedule)` does: step k uses lr_init·(lr_final/lr_init)^(k /
lr_decay_steps).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from fashion_nerf_torch.config import Config
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP, init_field


@dataclass
class TrainState:
    step: int
    coarse: NeRFMLP
    fine: Optional[NeRFMLP]
    optimizer: torch.optim.Adam
    generator: torch.Generator

    def nets(self) -> dict:
        return {k: v for k, v in (("coarse", self.coarse),
                                  ("fine", self.fine)) if v is not None}

    def parameters(self):
        return [p for net in self.nets().values() for p in net.parameters()]


def learning_rate(cfg: Config, step: int) -> float:
    t = cfg.train
    return t.lr_init * (t.lr_final / t.lr_init) ** (step / t.lr_decay_steps)


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate(cfg, 0),
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: Config, init_generator: torch.Generator,
                       run_generator: torch.Generator,
                       device=None) -> TrainState:
    """Fresh nets (coarse, and fine when cfg samples a fine pass) drawn
    from init_generator; the step's draws come from run_generator, which
    must live on `device`."""
    coarse = init_field(cfg.model, init_generator, device)
    fine = (init_field(cfg.model, init_generator, device)
            if cfg.sampling.n_fine > 0 else None)
    params = [p for n in (coarse, fine) if n is not None
              for p in n.parameters()]
    return TrainState(step=0, coarse=coarse, fine=fine,
                      optimizer=make_optimizer(cfg, params),
                      generator=run_generator)
