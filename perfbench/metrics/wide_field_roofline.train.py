"""wide_field_roofline.train: K7's training forward on mip-NeRF 360's NeRF
MLP (the render's kernels, its activations kept) for the NeRF rows the
steps need (`fine_needed`): its least time over the device time of the
operations launched inside the host range "fnt.kernel.wide_field" in the
traced window, in %; the bytes are wide_field_roofline's and the kept
activations written. None where the program has no such range."""

from perfbench import m360_counts, roofline

SPAN = "fnt.kernel.wide_field"
# a row's Gaussian read and rgb and σ written (f32), as wide_field_roofline
ROW_BYTES = 40


def read(rec):
    t = rec.trace
    if (t is None or not rec.counts or not t.under.get(SPAN)
            or "fine_bwd_bytes" not in rec.flops):
        return None
    rows = sum(c["fine_needed"] for c in rec.counts)
    kept = rec.flops["fine_bwd_bytes"] - m360_counts.COTANGENT_BYTES_VD
    bound = roofline.bound_s(rows * rec.flops["fine"],
                             rows * (ROW_BYTES + kept))
    return roofline.share(bound, t.under[SPAN])
