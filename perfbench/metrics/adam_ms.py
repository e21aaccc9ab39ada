"""adam_ms: device time of the operations launched inside the optimizer's
step (the host span "Optimizer.step#Adam.step") per step of the traced
window, in ms."""

SPAN = "Optimizer.step#Adam.step"


def read(rec):
    t = rec.trace
    if t is None or not rec.unit_s or not t.under.get(SPAN):
        return None
    return 1e3 * t.under[SPAN] / len(rec.unit_s)
