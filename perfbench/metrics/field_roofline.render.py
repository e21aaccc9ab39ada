"""field_roofline.render: the field kernel's (K3, the two-stage march's
field rows) least time for the rows the frames need, over its device time
in the traced window, in %. Kernel names: field_roofline.render.json."""

import json
import os

from perfbench import roofline

KERNELS = json.load(open(os.path.join(
    os.path.dirname(__file__), "field_roofline.render.json")))["kernels"]


def read(rec):
    t = rec.trace
    if t is None or not rec.counts:
        return None
    rows = sum(c["coarse_needed"] + c["fine_needed"] for c in rec.counts)
    bound = roofline.bound_s(roofline.needed_flops(rec.counts, rec.flops),
                             rows * roofline.ROW_BYTES)
    return roofline.share(bound, t.seconds(KERNELS))
