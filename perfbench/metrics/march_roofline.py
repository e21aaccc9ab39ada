"""march_roofline: the marches' (K1, the σ-only proposal march, and K2,
the fine march) least time for the work the frames need, over their
device time in the traced window, in %. Kernel names:
march_roofline.json."""

import json
import os

from perfbench import roofline

KERNELS = json.load(open(os.path.join(os.path.dirname(__file__),
                                      "march_roofline.json")))["kernels"]


def read(rec):
    t = rec.trace
    if t is None or not rec.counts:
        return None
    samples = sum(c["coarse_needed"] + c["fine_needed"] for c in rec.counts)
    rays = sum(c["alive"] for c in rec.counts)
    bound = roofline.bound_s(
        roofline.needed_flops(rec.counts, rec.flops),
        samples * roofline.SAMPLE_BYTES + rays * roofline.RAY_BYTES)
    return roofline.share(bound, t.seconds(KERNELS))
