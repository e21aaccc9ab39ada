"""prop_field_roofline.train: K7's training forward on mip-NeRF 360's
proposal MLP, both rounds, for the proposal rows the steps need
(`coarse_needed`): its least time over the device time of the operations
launched inside the host range "fnt.kernel.prop_field" in the traced
window, in %; the bytes are prop_field_roofline's and the kept activations
written. None where the program has no such range."""

from perfbench import m360_counts, roofline

SPAN = "fnt.kernel.prop_field"
# a row's Gaussian read and σ written (f32), as prop_field_roofline
ROW_BYTES = 28


def read(rec):
    t = rec.trace
    if (t is None or not rec.counts or not t.under.get(SPAN)
            or "proposal_bwd_bytes" not in rec.flops):
        return None
    rows = sum(c["coarse_needed"] for c in rec.counts)
    kept = rec.flops["proposal_bwd_bytes"] - m360_counts.COTANGENT_BYTES
    bound = roofline.bound_s(rows * rec.flops["proposal"],
                             rows * (ROW_BYTES + kept))
    return roofline.share(bound, t.under[SPAN])
