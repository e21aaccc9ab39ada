"""Named, single-use generators; counterpart of `fashion_nerf.prng.KeyChain`.

Every draw the trainer makes outside its step comes from a generator the
chain hands out once per label, seeded from the run's seed; after
`freeze()` the chain refuses to hand out more, so the set-up draws and the
per-step stream (the TrainState's own generator) never share a source.
"""

from __future__ import annotations

import torch


class GeneratorReuseError(RuntimeError):
    pass


class GeneratorChain:
    """chain = GeneratorChain(seed); g = chain.once("init", device)."""

    def __init__(self, seed: int):
        self._seeder = torch.Generator().manual_seed(int(seed))
        self._frozen = False
        self._used: set = set()

    def once(self, label: str, device=None) -> torch.Generator:
        """A fresh generator on `device`; each label may be drawn once."""
        if self._frozen:
            raise GeneratorReuseError("GeneratorChain is frozen")
        if label in self._used:
            raise GeneratorReuseError(f"label {label!r} drawn twice")
        self._used.add(label)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._seeder))
        return torch.Generator(device=device or "cpu").manual_seed(seed)

    def freeze(self) -> None:
        self._frozen = True
