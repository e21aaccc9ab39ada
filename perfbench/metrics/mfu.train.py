"""mfu.train: the field operations the window's steps need over the
traced window at the card's bf16 peak, in %: forward and backward (three
times the forward) of every row the steps evaluate (each ray's coarse and
fine samples, the density prior's points, both nets) and the forward of
the occupancy refreshes' lattice (perfbench/roofline.py)."""

from perfbench import roofline


def read(rec):
    t = rec.trace
    if t is None or not rec.counts or t.window_s <= 0:
        return None
    f = rec.flops["fine"]
    need = sum(3 * c["train_rows"] * f + c["refresh_rows"] * f
               for c in rec.counts)
    return 100.0 * need / (t.window_s * roofline.PEAK_BF16_FLOPS)
