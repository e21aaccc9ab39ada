"""The reference's quality checks of `scripts/quality_check.py`: the
7-pose gate (`--gate`) and the spec sweep (without it).

Both render the committed trained `blender_lego` weights at 800×800 and
score the renders in PSNR against the analytic ground truth of the scene
they were trained on: 512 samples per ray of the analytic field over
[2, 6], composited with the reference's f32 cumprod, computed on the
device in row strips (no cache file).

The gate: for each of seven camera poses, the production render (the
shipped preset with the `--extra` overrides, the 64³ occupancy sweep
through K3 and the committed proposal asset, through
`render_image_blockwise`: K1 + K2, or K1 + K6 under
`kernels.carry_hoist=false`) against the dense 64+128 reference
(occupancy and proposal off, eval budgets 0, through
`render/renderer.py::render_image` with K3 fields and the plain volume
render). It passes when, at every pose, the production render loses less
than 0.1 dB against the dense one (delta = prod vs GT − dense vs GT >
−0.1 dB). Mrays/s is the steady state of a second production render of
the pose, host clock around a synchronize.

The spec sweep (`run_sweep`, the reference's `specs`, kept as SPECS):
each row's budget, occupancy, march and proposal switches on top of the
preset, at one pose; the dense, culled and fast rows through
`render_image` with K3 fields and the row's occupancy, the rest through
`render_image_blockwise`; a proposal row distils its own proposal
(`attach_proposal(use_asset=False)`, one per distillation setting). Each
row prints its PSNR against the GT, against `dense 64+128`, its delta
against dense and its seconds; a proposal row also its student's health
(`distill_health`).

    python -m fashion_nerf_torch.quality --gate [--extra k=v,...]
        [--poses i,j] [--device cpu|cuda] [--size N]
    python -m fashion_nerf_torch.quality [--only a,b] [--pose i]
        [--extra k=v,...] [--device cpu|cuda] [--size N]

`--gate` exits 1 when the worst pose's delta is ≤ −0.1 dB. Without a CUDA
device both raise unless `--device cpu` is given (then the plain versions
render; keep it small, e.g. `--size 16 --extra occupancy.resolution=32`,
and for the sweep `proposal.distill_steps=20`).
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from fashion_nerf_torch.assets import load_flagship
from fashion_nerf_torch.config import load_config
from fashion_nerf_torch import bench
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.occupancy import build_from_config
from fashion_nerf_torch.data.synthetic import field_torch
from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import (DISTILL_SEED, attach_proposal,
                                                distill_health)
from fashion_nerf_torch.render.blockwise import render_image_blockwise
from fashion_nerf_torch.render.renderer import render_image

GATE_DB = -0.1
DENSE = ("occupancy.enabled=false", "proposal.enabled=false",
         "render.eval_n_coarse=0", "render.eval_n_fine=0")

# the reference's spec sweep, row for row (scripts/quality_check.py:282-485)
SPECS = [
    ("dense 64+128", dict(n_coarse=64, n_fine=128, occ_on=False)),
    ("culled 64+128", dict(n_coarse=64, n_fine=128, occ_on=True)),
    ("fast (culled 32+64)", dict(n_coarse=32, n_fine=64, occ_on=True)),
    ("blockwise 64+128 eps1e-4",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True)),
    ("blockwise 32+64",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True)),
    ("blockwise carry 64+128",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",))),
    ("blockwise carry 32+64",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",))),
    ("blockwise 64+128 macro=1",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True,
          extra=("occupancy.macro=1",))),
    ("blockwise 16+32",
     dict(n_coarse=16, n_fine=32, occ_on=True, blockwise=True)),
    ("blockwise carry 16+32",
     dict(n_coarse=16, n_fine=32, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",))),
    ("blockwise carry 32+32",
     dict(n_coarse=32, n_fine=32, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",))),
    ("blockwise carry 24+48",
     dict(n_coarse=24, n_fine=48, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",))),
    ("blockwise carry 32+64 macro=8",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8"))),
    ("blockwise carry 32+64 macro=16 res=128",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=16",
                 "occupancy.resolution=128"))),
    ("blockwise carry 32+64 eps=1e-3",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3"))),
    ("carry 64+128 thr.05",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",
                 "occupancy.sigma_threshold=0.05"))),
    ("carry 64+128 thr.02",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",
                 "occupancy.sigma_threshold=0.02"))),
    ("carry 64+128 mw.25",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",
                 "occupancy.margin_world=0.25"))),
    ("carry 64+128 thr.02 mw.25",
     dict(n_coarse=64, n_fine=128, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true",
                 "occupancy.sigma_threshold=0.02",
                 "occupancy.margin_world=0.25"))),
    ("blockwise carry 32+64 SB=64",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3",
                 "kernels.block_samples=64"))),
    ("blockwise carry 64+64 SB=64",
     dict(n_coarse=64, n_fine=64, occ_on=True, blockwise=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3",
                 "kernels.block_samples=64"))),
    ("proposal p64+f64 mix.25 dil2",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=0", "proposal.dilate=2",
                 "proposal.uniform_mix=0.25"))),
    ("proposal p64+f64 mix.25 dil2 w192L8",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=0", "proposal.dilate=2",
                 "proposal.uniform_mix=0.25", "proposal.net_width=192",
                 "proposal.posenc_xyz=8",
                 "proposal.distill_steps=1500"))),
    ("proposal p64+f64 mix.2 dil2 w192L8",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=0", "proposal.dilate=2",
                 "proposal.uniform_mix=0.2", "proposal.net_width=192",
                 "proposal.posenc_xyz=8",
                 "proposal.distill_steps=1500"))),
    ("proposal p64+f64 mix.2 dil2 ds2000",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=0", "proposal.dilate=2",
                 "proposal.uniform_mix=0.2",
                 "proposal.distill_steps=2000"))),
    ("proposal p64+f64 mix.4 dil2",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=0", "proposal.dilate=2",
                 "proposal.uniform_mix=0.4"))),
    ("proposal p64+f64 mix.15 dil1",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=0", "proposal.dilate=1",
                 "proposal.uniform_mix=0.15"))),
    ("proposal p64+f48+cov16 dil2",
     dict(n_coarse=32, n_fine=48, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16", "proposal.dilate=2"))),
    ("proposal p32+f48+cov16 dil2",
     dict(n_coarse=32, n_fine=48, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=32",
                 "proposal.cov_n=16", "proposal.dilate=2"))),
    ("proposal p32+f64 mix.25 dil2",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=32",
                 "proposal.cov_n=0", "proposal.dilate=2",
                 "proposal.uniform_mix=0.25"))),
    ("proposal p64+f64+cov16",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16"))),
    ("proposal p64+f64+cov16 dil0",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16", "proposal.dilate=0"))),
    ("proposal p64+f64+cov16 dil2",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16", "proposal.dilate=2"))),
    ("proposal p64+f64+cov16 ds1500",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16", "proposal.distill_steps=1500"))),
    ("proposal p64+f64+cov16 w256d3",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16", "proposal.net_width=256",
                 "proposal.net_depth=3", "proposal.posenc_xyz=8",
                 "proposal.distill_steps=1500"))),
    ("proposal p64+f64+cov8",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=8"))),
    ("proposal p64+f64+cov32",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=32"))),
    ("proposal p64+f48+cov16",
     dict(n_coarse=32, n_fine=48, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16"))),
    ("proposal p64+f32+cov16",
     dict(n_coarse=32, n_fine=32, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.cov_n=16"))),
    ("proposal p64+f64 union",
     dict(n_coarse=32, n_fine=64, occ_on=True, blockwise=True,
          proposal=True,
          extra=("kernels.fused_carry=true", "occupancy.macro=8",
                 "kernels.early_term_eps=1e-3", "proposal.eval_n=64",
                 "proposal.union=true"))),
]


def look_at(eye) -> np.ndarray:
    """OpenGL/NeRF c2w (camera −z = view dir, y up) looking at the origin,
    (3, 4) f32."""
    eye = np.asarray(eye, np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)[:3]
    m[:, 0], m[:, 1], m[:, 2], m[:, 3] = right, up, -fwd, eye
    return m


def ring(az_deg: float, el_deg: float, r: float) -> np.ndarray:
    az, el = math.radians(az_deg), math.radians(el_deg)
    return look_at([r * math.cos(el) * math.sin(az), r * math.sin(el),
                    r * math.cos(el) * math.cos(az)])


# pose 0 is the bench framing; the rest are off-axis, near, far, low, and
# the two adversarial poses (closer than any tuning pose, near top-down)
POSES = [
    ("bench z=4", np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]],
                           np.float32)),
    ("az30 el10 r4", ring(30, 10, 4.0)),
    ("az-45 el20 r3.2 (near)", ring(-45, 20, 3.2)),
    ("az120 el35 r5 (far)", ring(120, 35, 5.0)),
    ("az200 el-15 r4.5", ring(200, -15, 4.5)),
    ("az60 el25 r2.6 (closer)", ring(60, 25, 2.6)),
    ("az10 el75 r4 (top-down)", ring(10, 75, 4.0)),
]


def scene_params(meta) -> dict:
    """The analytic scene the flagship weights were trained on."""
    return {"scale": float(meta.get("scene_scale", 1.0)),
            "sharp": float(meta.get("scene_sharp", 25.0)),
            "texture": float(meta.get("scene_texture", 0.0))}


def gt_render(c2w, H: int, W: int, focal: float, scene: dict,
              n_samples: int = 512, near: float = 2.0, far: float = 6.0,
              strip: int = 50, device=None):
    """Analytic ground truth → (H, W, 3) f32 in [0, 1] on `device`: rays
    as the reference's strips build them, `n_samples` uniform samples over
    [near, far], f32 cumprod(1 − α + 1e-10) transmittance, white
    background. Rows go `strip` at a time: a strip of 800-pixel rows is
    409,600 samples per row."""
    R = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
    t = torch.linspace(near, far, n_samples, dtype=torch.float32,
                       device=device)
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    out = []
    for y0 in range(0, H, strip):
        rows = min(strip, H - y0)
        j = (y0 + torch.arange(rows, dtype=torch.float32,
                               device=device))[:, None]
        dirs = torch.stack([((i - W * .5) / focal).expand(rows, W),
                            (-(j - H * .5) / focal).expand(rows, W),
                            -torch.ones((rows, W), device=device)], -1)
        rays_d = dirs @ R[:3, :3].T
        rays_o = R[:3, -1].expand(rays_d.shape)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
        rgb, sigma = field_torch(pts, **scene)
        delta = (far - near) / (n_samples - 1) * torch.linalg.norm(
            rays_d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-sigma * delta)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]),
                           trans[..., :-1]], -1)
        w = alpha * trans
        img = (w[..., None] * rgb).sum(-2) + (1.0 - w.sum(-1)[..., None])
        out.append(torch.clamp(img, 0, 1))
    return torch.cat(out, 0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_gate(cfg_overrides=(), poses=None, device=None, H: int = 800,
             W: int = 800, cache: dict = None, log=print) -> dict:
    """The gate over `poses` (indices into POSES; default all) →
    {"rows": [{pose, name, dense_vs_gt, prod_vs_gt, delta, mrays, image}],
    "worst", "worst_pose", "worst_mrays", "ok"}. cache: a dict that keeps
    each pose's (GT, dense) images across calls of the same size, so a
    second production config is scored against the same references."""
    device = K.resolve_device(device)
    loaded = load_flagship()
    if loaded is None:
        raise FileNotFoundError("assets/flagship_synthetic.npz is missing")
    scene = scene_params(loaded[1])
    focal, _ = bench.bench_pose(W)
    cache = {} if cache is None else cache
    poses = list(range(len(POSES))) if poses is None else list(poses)

    prod_cfg = load_config("blender_lego", list(cfg_overrides))
    params, occ, _ = bench.setup(prod_cfg, device)
    dense_cfg = load_config("blender_lego", list(DENSE))
    field = make_fused_field()

    def prod(c2w):
        with torch.no_grad():
            img = render_image_blockwise(params, prod_cfg, H, W, focal, c2w,
                                         occ=occ, device=device)["rgb"]
        _sync(device)
        return img

    def references(i):
        key = (i, H, W)
        if key not in cache:
            c2w = POSES[i][1]
            with torch.no_grad():
                gt = gt_render(c2w, H, W, focal, scene, device=device)
                dense = render_image(
                    lambda p, v: field(params["coarse"], p, v),
                    lambda p, v: field(params["fine"], p, v), H, W, focal,
                    c2w,
                    dense_cfg, device=device)["rgb"]
            cache[key] = (gt, dense)
        return cache[key]

    log(f"\n{'pose':26s} {'dense vs GT':>12s} {'prod vs GT':>12s} "
        f"{'delta':>8s} {'Mrays/s':>8s}")
    rows = []
    for i in poses:
        name, c2w = POSES[i]
        gt, dense = references(i)
        img = prod(c2w)
        t0 = time.perf_counter()
        prod(c2w)
        rps = H * W / (time.perf_counter() - t0)
        d_gt = float(psnr(dense, gt))
        p_gt = float(psnr(img, gt))
        row = {"pose": i, "name": name, "dense_vs_gt": d_gt,
               "prod_vs_gt": p_gt, "delta": p_gt - d_gt, "mrays": rps / 1e6,
               "image": img}
        rows.append(row)
        log(f"{name:26s} {d_gt:12.2f} {p_gt:12.2f} {row['delta']:+8.3f} "
            f"{row['mrays']:8.3f}")
    worst = min(rows, key=lambda r: r["delta"])
    ok = worst["delta"] > GATE_DB
    worst_mrays = min(r["mrays"] for r in rows)
    log(f"\nworst-pose delta {worst['delta']:+.3f} dB ({worst['name']}) — "
        f"{'PASS' if ok else 'FAIL'} (gate {GATE_DB}); worst-pose throughput "
        f"{worst_mrays:.3f} Mrays/s")
    return {"rows": rows, "worst": worst["delta"],
            "worst_pose": worst["name"], "worst_mrays": worst_mrays,
            "ok": ok}


def sweep_config(n_coarse: int, n_fine: int, blockwise: bool = False,
                 extra=(), overrides=()):
    """A row's config, as the reference builds it: the preset with the
    row's budget (its eval budget too, so that it applies), occupancy on,
    the kernels for a blockwise row, the row's extra, then `overrides`."""
    return load_config("blender_lego", [
        f"sampling.n_coarse={n_coarse}", f"sampling.n_fine={n_fine}",
        f"render.eval_n_coarse={n_coarse}", f"render.eval_n_fine={n_fine}",
        "occupancy.enabled=true"] + (
        ["kernels.use_pallas=true"] if blockwise else []) + list(extra)
        + list(overrides))


def run_sweep(only=(), pose: int = 0, device=None, H: int = 800,
              W: int = 800, overrides=(), log=print, gt=None,
              seed: int = DISTILL_SEED) -> dict:
    """The spec sweep at POSES[pose]: every row of SPECS whose name holds
    one of `only` (all rows when empty; `dense 64+128` always, first) →
    {"rows": [{name, psnr_gt, psnr_dense, delta, seconds, image,
    proposal}], "pose"}. psnr_dense and delta are None on the dense row;
    proposal: `distill_health` of a proposal row's student (else None),
    with the distillation's seconds and the student itself ("net"). overrides: dotted settings applied
    to every row after its own. gt: the pose's GT image, if at hand.
    seed: the distillations' (`attach_proposal`'s default)."""
    device = K.resolve_device(device)
    loaded = load_flagship()
    if loaded is None:
        raise FileNotFoundError("assets/flagship_synthetic.npz is missing")
    trained, meta = loaded
    focal, _ = bench.bench_pose(W)
    name, c2w = POSES[pose]
    if gt is None:
        with torch.no_grad():
            gt = gt_render(c2w, H, W, focal, scene_params(meta),
                           device=device)
    log(f"GT ready (pose {pose}: {name})")
    specs = [(n, kw) for n, kw in SPECS if n == "dense 64+128" or not only
             or any(w in n for w in only)]
    proposals, grids = {}, {}
    dtype = load_config("blender_lego").model.compute_dtype
    base = {k: load_flax_params(v, compute_dtype=dtype, device=device)
            for k, v in trained.items()}

    def render(n_coarse, n_fine, occ_on, blockwise=False, extra=(),
               proposal=False):
        cfg = sweep_config(n_coarse, n_fine, blockwise, extra, overrides)
        nets = dict(base)
        field = make_fused_field()
        occ = None
        if occ_on:
            # one sweep per occupancy setting: the reference sweeps anew
            # for every row, with the same result
            if cfg.occupancy not in grids:
                with torch.no_grad():
                    grids[cfg.occupancy] = build_from_config(
                        cfg, lambda p, v: field(nets["fine"], p, v),
                        device=device)
            occ = grids[cfg.occupancy]
        health = None
        if proposal:
            # one distillation per distillation setting, shared across the
            # rows' render budgets
            p = cfg.proposal
            key = (p.net_depth, p.net_width, p.posenc_xyz, p.distill_steps,
                   p.distill_batch, p.distill_lr)
            if key not in proposals:
                t0 = time.perf_counter()
                prop = attach_proposal(
                    cfg, nets, occ=occ, use_asset=False, device=device,
                    generator=torch.Generator().manual_seed(seed))["proposal"]
                _sync(device)
                health = distill_health(
                    cfg, lambda p, v: field(nets["fine"], p, v), prop,
                    occ.box_min, occ.box_max)
                proposals[key] = (prop, dict(
                    health, seconds=time.perf_counter() - t0, net=prop))
            nets["proposal"], health = proposals[key]
        with torch.no_grad():
            if blockwise:
                img = render_image_blockwise(nets, cfg, H, W, focal, c2w,
                                             occ=occ, device=device)["rgb"]
            else:
                img = render_image(
                    lambda p, v: field(nets["coarse"], p, v),
                    lambda p, v: field(nets["fine"], p, v), H, W, focal,
                    c2w, cfg, occ=occ, device=device)["rgb"]
        _sync(device)
        return img, health

    log(f"\n{'path':26s} {'PSNR vs GT':>12s} {'PSNR vs dense':>14s}")
    rows, dense, d_gt = [], None, None
    for row_name, kw in specs:
        t0 = time.perf_counter()
        img, health = render(**kw)
        secs = time.perf_counter() - t0
        vs_gt = float(psnr(img, gt))
        row = {"name": row_name, "psnr_gt": vs_gt, "psnr_dense": None,
               "delta": None, "seconds": secs, "image": img,
               "proposal": health}
        if row_name == "dense 64+128":
            dense, d_gt = img, vs_gt
            log(f"{row_name:26s} {vs_gt:12.2f} {'—':>14s}   {secs:.2f} s")
        else:
            row["psnr_dense"] = float(psnr(img, dense))
            row["delta"] = vs_gt - d_gt
            line = (f"{row_name:26s} {vs_gt:12.2f} {row['psnr_dense']:14.2f}"
                    f"   delta-vs-dense {row['delta']:+.3f} dB   "
                    f"{secs:.2f} s")
            if health is not None:
                line += (f"   proposal: σ > 0 on {health['share']:.3f} of "
                         f"the box, MSE {health['mse']:.4f} (teacher's mean "
                         f"square {health['teacher_ms']:.4f})"
                         f"{', DEAD' if health['dead'] else ''}")
            log(line)
        rows.append(row)
    return {"rows": rows, "pose": pose}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", action="store_true",
                    help="the multi-pose gate (default: the spec sweep)")
    ap.add_argument("--extra", default="",
                    help="comma-separated dotted overrides of the "
                    "production config (the gate) or of every row (the "
                    "sweep)")
    ap.add_argument("--poses", default="",
                    help="comma-separated POSES indices (default: all)")
    ap.add_argument("--only", default="",
                    help="the sweep: comma-separated substrings of the "
                    "rows' names (default: every row)")
    ap.add_argument("--pose", type=int, default=0,
                    help="the sweep: the POSES index it renders")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=800,
                    help="frame height and width (default 800)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = K.resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    print(f"device: {kind}", flush=True)
    extra = [s.strip() for s in args.extra.split(",") if s.strip()]

    def log(m):
        print(m, flush=True)

    if not args.gate:
        only = [s.strip() for s in args.only.split(",") if s.strip()]
        run_sweep(only, args.pose, device, H=args.size, W=args.size,
                  overrides=extra, log=log)
        return 0
    poses = [int(s) for s in args.poses.split(",") if s.strip()] or None
    res = run_gate(extra, poses, device, H=args.size, W=args.size, log=log)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
