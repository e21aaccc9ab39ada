"""field_bwd_roofline: the field backward's (K4: its rows, weight-gradient
and row-sum kernels) least time for the steps' backward, twice the
forward operations of every row (the input and the weight gradients),
over its device time in the traced window, in %. Kernel names:
field_bwd_roofline.json."""

import json
import os

from perfbench import roofline

KERNELS = json.load(open(os.path.join(
    os.path.dirname(__file__), "field_bwd_roofline.json")))["kernels"]
# a row's point and its rgb and σ cotangents read, f32
BWD_ROW_BYTES = 28


def read(rec):
    t = rec.trace
    if t is None or not rec.counts:
        return None
    rows = sum(c["train_rows"] for c in rec.counts)
    bound = roofline.bound_s(2 * rows * rec.flops["fine"],
                             rows * BWD_ROW_BYTES)
    return roofline.share(bound, t.seconds(KERNELS))
