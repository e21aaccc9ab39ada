#!/usr/bin/env python3
"""Where the time of one 800×800 blender_lego frame goes, on one GPU.

    PYTHONPATH=src python scripts/torch_frame_profile.py [--plain] [--frames N]

Sets up as `fashion_nerf_torch.bench` does, renders one warm-up frame, times
N frames with the host clock around `torch.cuda.synchronize()`, then traces
one more frame with `torch.profiler` and prints the device time per kernel
(device events only), their sum per frame, and the device busy share
(kernel time / unprofiled frame time; one stream, so kernels do not
overlap). --plain renders through the plain PyTorch versions instead of
the CUDA kernels.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fashion_nerf.config import load_config  # noqa: E402
from fashion_nerf_torch.bench import bench_pose, setup  # noqa: E402
from fashion_nerf_torch.render.blockwise import (  # noqa: E402
    render_image_blockwise)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("blender_lego")
    dev = torch.device("cuda", 0)
    params, occ, setup_s = setup(cfg, dev)
    focal, c2w = bench_pose(800)

    def frame():
        render_image_blockwise(params, cfg, 800, 800, focal, c2w, occ=occ,
                               plain=args.plain, device=dev)
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
    print(f"{smi} | plain={args.plain} | setup {setup_s:.3f} s | frame "
          f"{wall * 1e3:.1f} ms (mean of {args.frames}) | device kernel "
          f"time {busy:.1f} ms/frame | busy share {busy / (wall * 1e3):.3f}")
    for name, us in per_kernel.most_common(15):
        print(f"{us / 1e3:9.2f} ms {count[name]:6d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
