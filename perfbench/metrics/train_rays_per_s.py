"""train_rays_per_s: every ray of every step completed in the window,
over the window's wall time (host clock)."""


def read(rec):
    return sum(rec.unit_work) / rec.window_s if rec.unit_s else None
