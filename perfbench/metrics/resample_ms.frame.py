"""resample_ms.frame: device time of the operations launched inside the
host range "fnt.rays.resample" (mip-NeRF 360's resampling of the proposal
weights' histogram) per frame of the traced window, in ms. None where the
program has no such range."""

SPAN = "fnt.rays.resample"


def read(rec):
    t = rec.trace
    if t is None or not rec.unit_s or not t.under.get(SPAN):
        return None
    return 1e3 * t.under[SPAN] / len(rec.unit_s)
