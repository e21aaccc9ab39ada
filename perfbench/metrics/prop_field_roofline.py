"""prop_field_roofline: the wide-field kernel's (K7 on mip-NeRF 360's
proposal MLP, both rounds) least time for the proposal rows the frames
need (`coarse_needed`), over the device time of the operations launched
inside the host range "fnt.kernel.prop_field" in the traced window, in %.
None where the program has no such range."""

from perfbench import roofline

SPAN = "fnt.kernel.prop_field"
# bytes a needed row moves: its Gaussian's mean and variance read (6 f32),
# its σ written (f32)
ROW_BYTES = 28


def read(rec):
    t = rec.trace
    if t is None or not rec.counts or not t.under.get(SPAN):
        return None
    rows = sum(c["coarse_needed"] for c in rec.counts)
    bound = roofline.bound_s(rows * rec.flops["proposal"], rows * ROW_BYTES)
    return roofline.share(bound, t.under[SPAN])
