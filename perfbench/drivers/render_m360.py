"""mip-NeRF 360's render generator: closed-loop frames of one client
through the program's `render_image_blockwise`, held against
perfbench/reference/mipnerf360.py.

A traffic file with "driver": "render_m360" gives what one with "driver":
"render" gives (drivers/render.py: "frame", "fov_x", "poses" with the
orbit's "phi_deg", "radius" and "stride", "overrides", "warm_frames",
"check_frames"). The configuration document's weights are "seeded": this
driver draws its own trees, those of mip-NeRF 360's two nets ("proposal":
`proposal.net_depth` × `proposal.net_width`, σ only; "fine": the NeRF MLP
with its bottleneck and view layer), LeCun-normal kernels truncated at ±2σ
and zero biases, from the run's seed on the device in one call, and hands
them to both sides.

What a cell of its own needs (a worked example; perfbench/README.md lists
the files by name): a configuration `configs/<config>.json` whose "config"
group the program's preset takes whole, with "preset" naming it; a traffic
mix `traffic/<traffic>.json` with "driver": "render_m360"; the cell's
limits `checks/<cell>.json`, set from `calibrate.py --workload <cell>`
(the program's sound runs against the fp8 control); and in BENCHMARK.json
the configuration, the cell, and the cell's name in the `workloads` of the
metrics it reports: render_rays_per_s, device_idle.render, mfu.render,
glue_ms.frame, and the three that read this driver's ranges,
wide_field_roofline, prop_field_roofline and resample_ms.frame. The
harness finds the driver by the traffic's "driver" (harness.driver_class).

The work is the same on every pose and for any weights (no culling, no
early termination), so the traced run's counts are exact without the
reference: every ray alive, `proposal.eval_n` proposal evaluations a round
over two rounds, `sampling.n_fine` NeRF evaluations. The reference renders
only the frames the comparison takes.

FAULTS: the planted faults of this driver's cells, for a harness that
looks them up here: perfbench/faults.py's three (the frame + 0.1, half
the rays, a stale frame), and two in the layers only this cell runs (the
resampling at the quantiles k/n, the variances left uncontracted).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from perfbench.drivers import render
from perfbench.drivers.common import program_config, sync
from perfbench.reference import mipnerf360 as ref

PROPOSAL_ROUNDS = 2


def net_shapes(cfg: dict) -> dict:
    """{"proposal", "fine"}: [(layer, rows, cols)] of mip-NeRF 360's nets
    as the "config" group gives them."""
    m, p = cfg["model"], cfg["proposal"]
    cx = 6 * m["ipe_deg"]

    def trunk(depth, width, skips):
        return [(f"trunk_{i}", cx if i == 0 else
                 width + (cx if (i - 1) in skips else 0), width)
                for i in range(depth)] + [("sigma_head", width, 1)]

    W, bn, view = m["net_width"], m["bottleneck_width"], m["view_width"]
    fine = trunk(m["net_depth"], W, m["skips"]) + [
        ("feature", W, bn), ("view_0", bn + 3 + 6 * m["posenc_dir"], view),
        ("rgb_head", view, 3)]
    return {"proposal": trunk(p["net_depth"], p["net_width"], []),
            "fine": fine}


def seeded_trees(cfg: dict, seed: int, device) -> dict:
    """The two nets' trees, drawn from the seed on the device."""
    shapes = net_shapes(cfg)
    n = sum(r * c for s in shapes.values() for _, r, c in s)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    trees, at = {}, 0
    for name, layers in shapes.items():
        params = {}
        for layer, rows, cols in layers:
            std = (1.0 / rows) ** 0.5 / 0.87962566103423978
            params[layer] = {
                "kernel": flat[at:at + rows * cols].view(rows, cols) * std,
                "bias": torch.zeros(cols, device=device)}
            at += rows * cols
        trees[name] = {"params": params}
    return trees


class Driver(render.Driver):
    """The cell's program, window units (frames) and comparison."""

    watch = ("fnt.kernel.wide_field", "fnt.kernel.prop_field",
             "fnt.rays.resample")

    def setup(self, timer) -> None:
        from fashion_nerf_torch import kernels as K
        from fashion_nerf_torch.models.mipnerf360 import from_tree, nets_of
        from fashion_nerf_torch.render.blockwise import (
            render_image_blockwise)
        timer("import")
        self.pcfg = cfg = program_config(self.doc["preset"], self.cfg)
        if self.device.type == "cuda":
            K.library()
        timer("kernel library")
        self.trees = seeded_trees(self.cfg, self.seed, self.device)
        kw = nets_of(cfg)
        self.setup_out = {"params": {k: from_tree(self.trees[k], self.device,
                                                  **kw[k])
                                     for k in ("proposal", "fine")},
                          "occ": None, "cond": None}
        sync(self.device)
        timer("weights")
        self._render = render_image_blockwise

    def reference(self, poses, quant=None) -> dict:
        nets = ref.build(self.trees, self.device, quant)
        out = {}
        for p in poses:
            f = ref.render_frame(self.cfg, nets, self.H, self.W, self.focal,
                                 self.poses[p], self.device)
            out[p] = {"rgb": f["rgb"].cpu(), "acc": f["acc"].cpu()}
        return out

    def check(self, traced: bool) -> dict:
        """The numbers compared over the frames drawn from the seed; when
        traced, the exact counts of every window frame in self.counts."""
        check_poses = self.check_poses()
        rays = self.H * self.W
        n_p, n_f = self.budget()
        self.counts = [{"alive": rays, "alive_fine": rays,
                        "coarse_needed": rays * n_p,
                        "fine_needed": rays * n_f}
                       for _ in self.rendered] if traced else []
        return self.compare(self.reference(check_poses))

    def control(self, quant: str) -> dict:
        if not hasattr(self, "trees"):
            self.trees = seeded_trees(self.cfg, self.seed, self.device)
        return super().control(quant)

    def flops(self) -> dict:
        """Operations per evaluation of each net."""
        from perfbench.roofline import eval_flops
        trees = (self.trees if hasattr(self, "trees")
                 else seeded_trees(self.cfg, self.seed, "cpu"))
        return {k: eval_flops(v) for k, v in trees.items()}

    def budget(self) -> tuple:
        """(proposal, NeRF) evaluations a ray: every interval of both
        proposal rounds, and the NeRF MLP's."""
        return (PROPOSAL_ROUNDS * self.cfg["proposal"]["eval_n"],
                self.cfg["sampling"]["n_fine"])


# --- planted faults ---------------------------------------------------------

@contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def altered():
    """Every chunk's rgb + 0.1."""
    from fashion_nerf_torch.render import m360

    def make(old):
        def f(*a, **k):
            out = dict(old(*a, **k))
            out["rgb"] = out["rgb"] + 0.1
            return out
        return f
    return _patched(m360, "render_rays_m360", make)


def half():
    """Every other ray of a chunk not rendered: the background."""
    from fashion_nerf_torch.render import m360

    def make(old):
        def f(*a, **k):
            out = dict(old(*a, **k))
            bg = 1.0 if a[1].render.white_bkgd else 0.0
            out["rgb"] = out["rgb"].clone()
            out["rgb"][1::2] = bg
            return out
        return f
    return _patched(m360, "render_rays_m360", make)


def stale():
    """Every frame the first one rendered."""
    from fashion_nerf_torch.render import blockwise
    first = []

    def make(old):
        def f(*a, **k):
            if not first:
                first.append(old(*a, **k))
            return first[0]
        return f
    return _patched(blockwise, "render_image_blockwise", make)


def resample_low():
    """The resampling at the quantiles k/n in place of (k + 0.5)/n: every
    resampled interval half a quantile early."""
    from fashion_nerf_torch.core import sampling

    def make(old):
        def f(bins, weights, n, eps=1e-5, *, quantiles=None, **k):
            if quantiles is not None:
                quantiles = quantiles - 0.5 / n
            return old(bins, weights, n, eps, quantiles=quantiles, **k)
        return f
    return _patched(sampling, "sample_pdf", make)


def uncontracted():
    """The Gaussians' means contracted and their variances not: diag Σ in
    place of diag J Σ Jᵀ."""
    from fashion_nerf_torch.core.cones import frustum_moments
    from fashion_nerf_torch.render import m360

    def make(old):
        def f(rays_o, rays_d, radius, tdist):
            mean, _ = old(rays_o, rays_d, radius, tdist)
            _, t_var, r_var = frustum_moments(tdist[:, :-1], tdist[:, 1:],
                                              radius)
            dd = torch.sum(rays_d * rays_d, dim=-1,
                           keepdim=True).clamp(min=1e-10)
            d = rays_d[:, None, :]
            return mean, ((t_var - r_var / dd)[..., None] * d * d
                          + r_var[..., None])
        return f
    return _patched(m360, "cone_gaussians", make)


FAULTS = {"altered": altered, "half": half, "stale": stale,
          "resample_low": resample_low, "uncontracted": uncontracted}
