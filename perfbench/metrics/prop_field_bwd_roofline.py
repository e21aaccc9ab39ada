"""prop_field_bwd_roofline: K7's backward on mip-NeRF 360's proposal MLP,
both rounds (perfbench/m360_counts.py), for the proposal rows the steps
need (`coarse_needed`), its least time over the device time of the
operations launched inside the host range "fnt.kernel.prop_field_bwd" in
the traced window, in %. None where the program has no such range."""

from perfbench import roofline

SPAN = "fnt.kernel.prop_field_bwd"


def read(rec):
    t = rec.trace
    if (t is None or not rec.counts or not t.under.get(SPAN)
            or "proposal_bwd" not in rec.flops):
        return None
    rows = sum(c["coarse_needed"] for c in rec.counts)
    bound = roofline.bound_s(rows * rec.flops["proposal_bwd"],
                             rows * rec.flops["proposal_bwd_bytes"])
    return roofline.share(bound, t.under[SPAN])
