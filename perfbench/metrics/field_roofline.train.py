"""field_roofline.train: the field kernel's (K3: the step's forward rows
and the refreshes' lattice) least time for the rows the steps need, over
its device time in the traced window, in %. Kernel names:
field_roofline.train.json."""

import json
import os

from perfbench import roofline

KERNELS = json.load(open(os.path.join(
    os.path.dirname(__file__), "field_roofline.train.json")))["kernels"]


def read(rec):
    t = rec.trace
    if t is None or not rec.counts:
        return None
    rows = sum(c["train_rows"] + c["refresh_rows"] for c in rec.counts)
    bound = roofline.bound_s(rows * rec.flops["fine"],
                             rows * roofline.ROW_BYTES)
    return roofline.share(bound, t.seconds(KERNELS))
