"""The card's peaks and the operations and bytes that a cell's inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit): 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of
HBM. A roofline share is the least time the card could take for the work
(the larger of operations / peak and bytes / bandwidth) over the device
time the kernels took.

Operations are counted from the layer shapes of the parameter tree, one
multiply-add as two operations, for the rows the inputs need: the samples
of the rays that are alive in their own right at each block (the
reference's count, never the program's launches). Hand count of the
8×256 field of `blender_lego` and `llff_fern` (L = 10, a skip after layer
4, view L = 4), multiply-adds per evaluation:

    trunk_0      63 × 256           16,128
    trunk_1..4   4 × 256 × 256     262,144
    trunk_5      (63 + 256) × 256   81,664
    trunk_6..7   2 × 256 × 256     131,072
    sigma_head   256 × 1               256
    feature      256 × 256          65,536
    view_0       (256 + 27) × 128   36,224
    rgb_head     128 × 3               384
    total                          593,408  → 1,186,816 operations

and of the 2×128 σ-only proposal (L = 6, no view branch; of its 4-wide
head only the σ lane is needed): 39 × 128 + 128 × 128 + 128 = 21,504
multiply-adds → 43,008 operations.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# bytes a needed sample of a march moves: its depth and width read, its
# weight written (f32); a ray: origin and direction read, rgb and acc
# written (f32)
SAMPLE_BYTES, RAY_BYTES = 12, 40
# bytes a needed row of the field kernel moves: its point read, rgb and σ
# written (f32)
ROW_BYTES = 28


def eval_macs(tree) -> int:
    """Multiply-adds of one evaluation of the net of a parameter tree
    ({"params": {layer: {"kernel": (in, out)}}}); a net without a view
    branch needs only the σ lane of its 4-wide head."""
    p = tree["params"] if "params" in tree else tree
    macs = 0
    for name, layer in p.items():
        rows, cols = np.shape(layer["kernel"])
        if name == "out_head":
            cols = 1
        macs += rows * cols
    return macs


def eval_flops(tree) -> int:
    return 2 * eval_macs(tree)


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_BF16_FLOPS, n_bytes / HBM_BYTES_PER_S)


def needed_flops(counts: list, flops: dict) -> float:
    """Operations of the samples the frames need: coarse pass (the
    proposal, or the coarse net) and fine march. counts: the reference's
    per-frame counts; flops: operations per evaluation by net."""
    coarse = flops.get("proposal", flops.get("coarse"))
    return sum(c["coarse_needed"] * coarse + c["fine_needed"] * flops["fine"]
               for c in counts)


def share(bound: float, seconds: float):
    """100 × bound / seconds, or None where nothing ran."""
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
