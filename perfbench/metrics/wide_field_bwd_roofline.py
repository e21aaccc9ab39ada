"""wide_field_bwd_roofline: K7's backward on mip-NeRF 360's NeRF MLP (its
weight and input gradients, perfbench/m360_counts.py) for the NeRF rows
the steps need (`fine_needed`), its least time over the device time of the
operations launched inside the host range "fnt.kernel.wide_field_bwd" in
the traced window, in %. None where the program has no such range."""

from perfbench import roofline

SPAN = "fnt.kernel.wide_field_bwd"


def read(rec):
    t = rec.trace
    if (t is None or not rec.counts or not t.under.get(SPAN)
            or "fine_bwd" not in rec.flops):
        return None
    rows = sum(c["fine_needed"] for c in rec.counts)
    bound = roofline.bound_s(rows * rec.flops["fine_bwd"],
                             rows * rec.flops["fine_bwd_bytes"])
    return roofline.share(bound, t.under[SPAN])
