"""render_rays_per_s: every pixel of every frame completed in the window,
over the window's wall time (host clock)."""


def read(rec):
    return sum(rec.unit_work) / rec.window_s if rec.unit_s else None
