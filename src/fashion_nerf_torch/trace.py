"""Named host ranges at the program's layer boundaries, on the profiler's
clock.

`span(name)` is a `torch.profiler.record_function` range while a
profiler records, and one shared null context otherwise: with no
profiler a span costs one check of `torch.autograd._profiler_enabled()`
(a `record_function` entered with the profiler off would cost tens of
times that on every frame). Every name starts with "fnt."; the ranges
land in the profiler's trace beside the kernels they launch
(`cli --profile`'s chrome trace, the benchmark's traced runs).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the host range `name` while a profiler records."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
