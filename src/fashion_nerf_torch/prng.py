"""Named, single-use generators; counterpart of `fashion_nerf.prng.KeyChain`.

Every draw the trainer makes outside its step comes from a generator the
chain hands out once per label, seeded from the run's seed; after
`freeze()` the chain refuses to hand out more, so the set-up draws and the
per-step stream (the TrainState's own generator) never share a source.
`RowDraws` hands a data-parallel rank its rows of the draws the
single-process step makes (`rand`, `randn`, `randint` take either).
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


class RowDraws:
    """Rows lo:hi of draws made at `total` rows from `generator`.

    The ranks of a data-parallel step hold the same generator state. Each
    draws every per-ray tensor at the global batch's shape and keeps its
    own rows, so its rays get the samples the single-process step gives
    them. Takes a generator's place in `rand`, `randn` and `randint`."""

    def __init__(self, generator: torch.Generator, lo: int, hi: int,
                 total: int):
        if not 0 <= lo <= hi <= total:
            raise ValueError(f"rows {lo}:{hi} of {total}")
        self.generator, self.lo, self.hi, self.total = generator, lo, hi, total

    @property
    def device(self) -> torch.device:
        return self.generator.device


def _draw(fn, args, shape, generator, device):
    if not isinstance(generator, RowDraws):
        return fn(*args, tuple(shape), generator=generator, device=device)
    r = generator
    if shape[0] != r.hi - r.lo:
        raise ValueError(f"{shape[0]} rows drawn, the slice holds "
                         f"{r.hi - r.lo}")
    full = fn(*args, (r.total,) + tuple(shape[1:]), generator=r.generator,
              device=device)
    return full[r.lo:r.hi]


def rand(shape, generator=None, device=None) -> torch.Tensor:
    """torch.rand from a generator or the rows of a RowDraws."""
    return _draw(torch.rand, (), shape, generator, device)


def randn(shape, generator=None, device=None) -> torch.Tensor:
    """torch.randn from a generator or the rows of a RowDraws."""
    return _draw(torch.randn, (), shape, generator, device)


def randint(high: int, shape, generator=None, device=None) -> torch.Tensor:
    """torch.randint(0, high) from a generator or the rows of a RowDraws."""
    return _draw(torch.randint, (0, high), shape, generator, device)
