"""Render benchmark of the port: rays/s of one 800×800 `blender_lego` frame
on one CUDA device. Counterpart of `fashion_nerf.bench.run_bench` for the
blockwise path; it prints the same JSON keys.

Setup (outside the timed loop): the committed trained flagship weights, the
64³ occupancy sweep of the fine field through kernel K3, and the committed
σ-only proposal net. Frame: `render_image_blockwise` through kernels K1 and
K2. Run as `python -m fashion_nerf_torch.bench`.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from fashion_nerf_torch.assets import load_flagship
from fashion_nerf_torch.config import Config, load_config
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.occupancy import build_from_config
from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
from fashion_nerf_torch.models.nerf_mlp import load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.render.blockwise import render_image_blockwise


def bench_pose(W: int):
    """Focal and camera-to-world of the reference bench: blender-standard
    fov, camera at z = 4 looking down −z."""
    focal = 0.5 * W / np.tan(0.5 * 0.6911)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return float(focal), c2w


def setup(cfg: Config, device):
    """→ (params {"fine", "coarse"} and, when the config takes one,
    "proposal", occ, setup seconds). Raises unless the committed flagship
    weights were trained for cfg."""
    loaded = load_flagship()
    if loaded is None:
        raise FileNotFoundError("assets/flagship_synthetic.npz is missing")
    trained, meta = loaded
    if str(meta.get("config", "")) != cfg.name:
        raise ValueError(f"flagship asset is for {meta.get('config')!r}, "
                         f"not {cfg.name!r}")
    t0 = time.perf_counter()
    nets = {k: load_flax_params(trained[k],
                                compute_dtype=cfg.model.compute_dtype,
                                device=device)
            for k in ("fine", "coarse")}
    field = make_fused_field(cfg)
    with torch.no_grad():
        occ = build_from_config(cfg, lambda p, v: field(nets["fine"], p, v),
                                device=device)
    # the committed asset, signed for the committed weights; the bench
    # measures that pair and does not distil a stand-in
    params = attach_proposal(cfg, nets, allow_distill=False, device=device)
    if (cfg.proposal.enabled and cfg.sampling.n_fine > 0
            and "proposal" not in params):
        raise FileNotFoundError(
            "assets/proposal_synthetic.npz is missing or was not distilled "
            "for the committed flagship weights and this config")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return params, occ, time.perf_counter() - t0


def run_bench(cfg: Config, device="cuda", H: int = 800, W: int = 800,
              warmup: int = 1, iters: int = 3) -> dict:
    """Render H×W with the blockwise path; report rays/sec on this card."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_bench needs a CUDA device; none is available")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"run_bench runs on a CUDA device, not {device}")
    params, occ, setup_s = setup(cfg, device)
    focal, c2w = bench_pose(W)

    def render():
        with torch.no_grad():
            return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                          occ=occ, device=device)

    for _ in range(warmup):
        render()
    K.reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        render()
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / iters

    n_p = cfg.proposal.eval_n or cfg.sampling.n_coarse
    n_f = cfg.render.eval_n_fine or cfg.sampling.n_fine
    return {
        "metric": ("rays/sec/chip at 800x800 render (coarse+fine, "
                   f"{n_f} full-MLP + {n_p} proposal-MLP evals/ray)"),
        "value": round(H * W / dt, 1),
        "unit": "rays/sec",
        # the port has no baseline of its own yet (PERF.md holds its first
        # numbers); the reference's ratio is not carried over
        "vs_baseline": None,
        "frame_seconds": round(dt, 4),
        "config": cfg.name,
        "pallas": False,
        "kernels": "cuda-sm90a",
        "blockwise": True,
        "trained_ckpt": True,
        "proposal": "proposal" in params,
        "occupancy_cull": True,
        "setup_seconds": round(setup_s, 3),
        "launches_per_frame": {k: v / iters for k, v in K.LAUNCHES.items()},
        "device": torch.cuda.get_device_name(device),
    }


def main():
    print(json.dumps(run_bench(load_config("blender_lego"))))


if __name__ == "__main__":
    main()
