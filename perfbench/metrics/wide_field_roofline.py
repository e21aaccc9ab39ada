"""wide_field_roofline: the wide-field kernel's (K7 on mip-NeRF 360's NeRF
MLP: its IPE operand, trunk and head) least time for the NeRF rows the
frames need (every interval of every ray, `fine_needed`), over the device
time of the operations launched inside the host range
"fnt.kernel.wide_field" in the traced window, in %. None where the program
has no such range."""

from perfbench import roofline

SPAN = "fnt.kernel.wide_field"
# bytes a needed row moves: its Gaussian's mean and variance read (6 f32),
# its rgb and σ written (4 f32)
ROW_BYTES = 40


def read(rec):
    t = rec.trace
    if t is None or not rec.counts or not t.under.get(SPAN):
        return None
    rows = sum(c["fine_needed"] for c in rec.counts)
    bound = roofline.bound_s(rows * rec.flops["fine"], rows * ROW_BYTES)
    return roofline.share(bound, t.under[SPAN])
