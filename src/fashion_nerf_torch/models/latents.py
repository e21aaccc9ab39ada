"""Per-frame latent codes for dynamic try-on; counterpart of
`fashion_nerf.models.latents`: a table indexed by frame id whose code joins
the field's conditioning input."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class LatentTable(nn.Module):
    def __init__(self, n_frames: int, dim: int):
        super().__init__()
        self.codes = nn.Embedding(n_frames, dim)

    def forward(self, frame_ids):
        """frame_ids (R,) int → (R, dim) codes."""
        return self.codes(frame_ids)

    def load_flax(self, tree: dict) -> "LatentTable":
        """Take the reference's parameter tree (codes/embedding)."""
        p = tree.get("params", tree)
        emb = np.asarray(p["codes"]["embedding"], np.float32)
        if emb.shape != tuple(self.codes.weight.shape):
            raise ValueError(f"latent table {emb.shape} does not fit "
                             f"{tuple(self.codes.weight.shape)}")
        with torch.no_grad():
            self.codes.weight.copy_(torch.from_numpy(emb.copy()))
        return self

    def init_flax_(self, generator: torch.Generator) -> "LatentTable":
        """flax's default `nn.Embed` init: N(0, 1/dim)."""
        with torch.no_grad():
            self.codes.weight.normal_(0.0, self.codes.weight.shape[1] ** -0.5,
                                      generator=generator)
        return self
