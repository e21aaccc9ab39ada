#!/usr/bin/env python3
"""Where the time of one 800×800 blender_lego frame, or of one training
step, goes on one GPU.

    PYTHONPATH=src python scripts/torch_frame_profile.py [--plain]
        [--frames N] [--train-step [--culled] [--tryon]]

Frame mode sets up as `fashion_nerf_torch.bench` does. --train-step
profiles a `blender_lego` training step (4096 rays, 64 + 128 samples,
sparsity prior) from the committed trained weights on the hermetic
training scene; --culled makes it the occupancy-culled step (32 + 64
samples inside the box of a grid refreshed from the nets); --tryon makes
it a `dynamic_tryon` step (2048 rays, the garment encoder and the latent
table in the step) from chip_smoke.py's try-on fixture on its hermetic
scene. Either way the
script runs one warm-up, times N runs with the host clock around
`torch.cuda.synchronize()`, then traces one more with `torch.profiler` and
prints the device time per kernel (device events only), their sum, and
the device busy share (kernel time / unprofiled time; one stream, so
kernels do not overlap). --plain runs the plain PyTorch versions instead
of the CUDA kernels.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fashion_nerf_torch.config import load_config  # noqa: E402
from fashion_nerf_torch.bench import bench_pose, setup  # noqa: E402
from fashion_nerf_torch.render.blockwise import (  # noqa: E402
    render_image_blockwise)


def train_step_workload(cfg, dev, args):
    """→ (one training step from the committed weights, set-up seconds)."""
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.train.loop import (TrainStep, load_dataset,
                                               refresh_occupancy)
    from fashion_nerf_torch.train.state import TrainState, make_optimizer
    t0 = time.perf_counter()
    if args.tryon:
        state, step, occ, ds = tryon_step_workload(dev, args)
        return _stepper(state, step, occ, ds), time.perf_counter() - t0
    scene = load_dataset(cfg)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    precrop_frac=cfg.train.precrop_frac, device=dev)
    trained, _ = load_flagship()
    nets = {k: load_flax_params(trained[k], compute_dtype="bfloat16",
                                device=dev) for k in ("coarse", "fine")}
    ps = [p for n in nets.values() for p in n.parameters()]
    state = TrainState(step=cfg.train.precrop_iters, coarse=nets["coarse"],
                       fine=nets["fine"], optimizer=make_optimizer(cfg, ps),
                       generator=torch.Generator(dev).manual_seed(0))
    step = TrainStep(cfg, ds, occ_culled=args.culled, plain=args.plain)
    occ = refresh_occupancy(cfg, state, args.plain) if args.culled else None
    return _stepper(state, step, occ, ds), time.perf_counter() - t0


def _stepper(state, step, occ, ds):
    """One training step on the dataset's rays, synchronised."""
    rays = ds.batch_arrays()

    def run():
        step(state, rays, occ)
        torch.cuda.synchronize()

    return run


def tryon_step_workload(dev, args):
    """(state, step, occupancy or None, dataset) of a dynamic_tryon step
    from chip_smoke.py's try-on fixture (the committed nets with cond rows,
    a seeded encoder and latent table) on its hermetic scene."""
    import numpy as np
    from chip_smoke import tryon_params
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.train.loop import (TrainStep, _eval_cond,
                                               load_dataset,
                                               refresh_occupancy,
                                               resolve_garment)
    from fashion_nerf_torch.train.state import state_from_params
    cfg = load_config("dynamic_tryon")
    scene = load_dataset(cfg, dev)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    device=dev)
    garment = resolve_garment(cfg, scene, ds.H, ds.W, dev)
    state = state_from_params(cfg, tryon_params(cfg, np.random.default_rng(
        9)), torch.Generator(dev).manual_seed(0), dev)
    step = TrainStep(cfg, ds, occ_culled=args.culled, plain=args.plain,
                     garment=garment)
    occ = None
    if args.culled:
        with torch.no_grad():
            cond = _eval_cond(cfg, state.nets(), garment)
        occ = refresh_occupancy(cfg, state, args.plain, cond_vec=cond)
    return state, step, occ, ds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--train-step", action="store_true")
    ap.add_argument("--culled", action="store_true")
    ap.add_argument("--tryon", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("blender_lego")
    dev = torch.device("cuda", 0)
    if args.train_step:
        frame, setup_s = train_step_workload(cfg, dev, args)
    else:
        torch.set_grad_enabled(False)
        params, occ, setup_s = setup(cfg, dev)
        focal, c2w = bench_pose(800)

        def frame():
            render_image_blockwise(params, cfg, 800, 800, focal, c2w,
                                   occ=occ, plain=args.plain, device=dev)
            torch.cuda.synchronize()

    frame()
    t0 = time.perf_counter()
    for _ in range(args.frames):
        frame()
    wall = (time.perf_counter() - t0) / args.frames
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
    per_kernel = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] += e.device_time_total
            count[e.name] += 1
    busy = sum(per_kernel.values()) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    what = ("culled " if args.culled else "") + (
        "dynamic_tryon " if args.tryon else "") + "train step"
    if not args.train_step:
        what = "frame"
    print(f"{smi} | plain={args.plain} | setup {setup_s:.3f} s | {what} "
          f"{wall * 1e3:.1f} ms (mean of {args.frames}) | device kernel "
          f"time {busy:.1f} ms | busy share {busy / (wall * 1e3):.3f}")
    for name, us in per_kernel.most_common(15):
        print(f"{us / 1e3:9.2f} ms {count[name]:6d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
