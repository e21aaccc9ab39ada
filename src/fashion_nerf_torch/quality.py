"""The 7-pose quality gate; counterpart of `scripts/quality_check.py --gate`.

For each of seven camera poses, the committed trained `blender_lego`
weights are rendered at 800×800 twice, and both renders are scored in PSNR
against the analytic ground truth of the scene they were trained on:
- the production render: the shipped preset (with the `--extra`
  overrides), the 64³ occupancy sweep through K3 and the committed
  proposal asset, through `render_image_blockwise` (K1 + K2, or K1 + K6
  under `kernels.carry_hoist=false`);
- the dense 64+128 reference: occupancy and proposal off, eval budgets 0,
  through `render/renderer.py::render_image` with K3 fields and the plain
  volume render.
The gate passes when, at every pose, the production render loses less
than 0.1 dB against the dense one (delta = prod vs GT − dense vs GT >
−0.1 dB). The ground truth is 512 samples per ray of the analytic field
over [2, 6], composited with the reference's f32 cumprod, recomputed on
the device in row strips (no cache file). Mrays/s is the steady state of
a second production render of the pose, host clock around a synchronize.

    python -m fashion_nerf_torch.quality --gate [--extra k=v,...]
        [--poses i,j] [--device cpu|cuda] [--size N]

Exits 1 when the worst pose's delta is ≤ −0.1 dB. Without a CUDA device it
raises unless `--device cpu` is given (then the plain versions render;
keep it small, e.g. `--size 16 --extra occupancy.resolution=32`). The
reference's spec sweep (quality_check.py without --gate) is not ported.
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
from fashion_nerf_torch.data.synthetic import field_torch
from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
from fashion_nerf_torch.metrics import psnr
from fashion_nerf_torch.render.blockwise import render_image_blockwise
from fashion_nerf_torch.render.renderer import render_image

GATE_DB = -0.1
DENSE = ("occupancy.enabled=false", "proposal.enabled=false",
         "render.eval_n_coarse=0", "render.eval_n_fine=0")


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
    field = make_fused_field(dense_cfg)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", action="store_true",
                    help="the multi-pose gate (the only mode ported)")
    ap.add_argument("--extra", default="",
                    help="comma-separated dotted overrides of the "
                    "production config")
    ap.add_argument("--poses", default="",
                    help="comma-separated POSES indices (default: all)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=800,
                    help="frame height and width (default 800)")
    args = ap.parse_args(argv)
    if not args.gate:
        raise NotImplementedError(
            "only --gate is ported; the spec sweep of "
            "scripts/quality_check.py is not (ROADMAP Queue 1 #8)")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = K.resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    print(f"device: {kind}", flush=True)
    extra = [s.strip() for s in args.extra.split(",") if s.strip()]
    poses = [int(s) for s in args.poses.split(",") if s.strip()] or None
    res = run_gate(extra, poses, device, H=args.size, W=args.size,
                   log=lambda m: print(m, flush=True))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
