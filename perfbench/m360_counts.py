"""Operations and bytes of mip-NeRF 360's training rows (K7's backward),
from the layer shapes of a parameter tree ({"params": {layer: {"kernel":
(in, out)}}}), one multiply-add as two operations.

What the backward of a row needs:
- every layer's weight gradient: in × out multiply-adds, the view layer's
  rows of the per-ray view term left out (its gradient is summed a ray, by
  the step's own matrix product after K7);
- the input gradient of every layer but the first (whose input, the IPE,
  depends on no parameter): out × in, the skip layer's IPE columns and the
  view layer's view-term rows left out.

Hand count of the 8×1024 NeRF MLP (IPE 72, skip after layer 4, bottleneck
256, view layer 128, view term 27), multiply-adds a row:

    weight gradients: 72·1024 + 7·1024² + 72·1024 + 1024 + 1024·256
                      + 256·128 + 128·3 = 7,783,808
    input gradients:  7·1024² + 1024 + 1024·256 + 256·128 + 128·3
                      = 7,636,352
    total 15,420,160 → 30,840,320 operations;

of the 4×256 proposal (IPE 72, σ only): 72·256 + 3·256² + 256 = 215,296
and 3·256² + 256 = 196,864, total 412,160 → 824,320 operations.

Bytes a row of the backward reads once (its outputs are the weight
gradients, a call's, and the view term's cotangent, a ray's): the kept
bf16 activations (the IPE's 6L features, every trunk layer's output, and
with a view branch the bottleneck's and the view layer's), and the f32
cotangents of σ and rgb with the kept rgb: 2·(72 + 8·1024 + 256 + 128)
+ 4·7 = 17,324 a NeRF row, 2·(72 + 4·256) + 4 = 2,196 a proposal row.
"""

from __future__ import annotations

import numpy as np

# f32 cotangents a row of the backward reads: σ's; with a view branch also
# rgb's and the kept rgb
COTANGENT_BYTES = 4
COTANGENT_BYTES_VD = 4 * (1 + 3 + 3)


def _layers(tree):
    p = tree["params"] if "params" in tree else tree
    return [(name, *np.shape(layer["kernel"])) for name, layer in p.items()]


def bwd_macs(tree, view_term: int = 27) -> int:
    """Multiply-adds of the backward of one row of the net of `tree`."""
    layers = _layers(tree)
    width = dict((n, c) for n, _, c in layers)["trunk_0"]
    wgrad = dgrad = 0
    for name, rows, cols in layers:
        if name == "view_0":
            rows -= view_term
        wgrad += rows * cols
        if name == "trunk_0":
            continue
        if name.startswith("trunk_") and rows > width:
            rows = width
        dgrad += rows * cols
    return wgrad + dgrad


def bwd_flops(tree, view_term: int = 27) -> int:
    return 2 * bwd_macs(tree, view_term)


def bwd_bytes(tree) -> int:
    """Bytes the backward of one row reads once (module docstring)."""
    layers = dict((n, (r, c)) for n, r, c in _layers(tree))
    ipe = layers["trunk_0"][0]
    act = ipe + sum(c for n, (r, c) in layers.items()
                    if n.startswith("trunk_"))
    if "feature" in layers:
        act += layers["feature"][1] + layers["view_0"][1]
        return 2 * act + COTANGENT_BYTES_VD
    return 2 * act + COTANGENT_BYTES
