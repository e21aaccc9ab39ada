"""setup_s: process start to the first timed unit (host clock): imports,
the kernel library, weights, occupancy, proposal and the warm-up."""


def read(rec):
    return rec.setup_s
