"""mfu.train_m360: mip-NeRF 360's training operations over the traced
window at the card's bf16 peak, in %: three times the forward operations
(forward, weight and input gradients) of every row of both nets that the
window's steps evaluate (each ray's proposal rows of both rounds and its
NeRF rows)."""

from perfbench import roofline


def read(rec):
    t = rec.trace
    if (t is None or not rec.counts or t.window_s <= 0
            or "proposal" not in rec.flops):
        return None
    need = sum(3 * (c["coarse_needed"] * rec.flops["proposal"]
                    + c["fine_needed"] * rec.flops["fine"])
               for c in rec.counts)
    return 100.0 * need / (t.window_s * roofline.PEAK_BF16_FLOPS)
