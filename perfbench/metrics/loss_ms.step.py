"""loss_ms.step: device time of the operations launched inside the host
range "fnt.step.losses" (mip-NeRF 360's Charbonnier, interlevel and
distortion losses, forward) per step of the traced window, in ms. None
where the program has no such range."""

SPAN = "fnt.step.losses"


def read(rec):
    t = rec.trace
    if t is None or not rec.unit_s or not t.under.get(SPAN):
        return None
    return 1e3 * t.under[SPAN] / len(rec.unit_s)
