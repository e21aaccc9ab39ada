"""glue_ms.frame: device time of the operations that are not the port's
kernels (names outside the `fnt::` namespace: torch's kernels, copies and
sets) per frame of the traced window, in ms."""

PORT = "fnt::"


def read(rec):
    t = rec.trace
    if t is None or not rec.unit_s:
        return None
    glue = sum(s for n, s in t.ops.items() if PORT not in n)
    return 1e3 * glue / len(rec.unit_s)
