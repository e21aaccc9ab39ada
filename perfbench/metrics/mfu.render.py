"""mfu.render: the field operations the window's frames need over the
traced window at the card's bf16 peak, in %. Need: the rays the
reference's culling keeps alive, times the configuration's budget of
coarse-pass (proposal or coarse net) and fine-march evaluations, times
each net's operations per evaluation (perfbench/roofline.py)."""

from perfbench import roofline


def read(rec):
    t = rec.trace
    if t is None or not rec.counts or t.window_s <= 0:
        return None
    n_c, n_f = rec.budget
    coarse = rec.flops.get("proposal", rec.flops.get("coarse"))
    need = sum(c["alive"] * n_c * coarse
               + c["alive_fine"] * n_f * rec.flops["fine"]
               for c in rec.counts)
    return 100.0 * need / (t.window_s * roofline.PEAK_BF16_FLOPS)
