#!/usr/bin/env python3
"""Times kernel K5 (the fused volume render, csrc/volrend.cu) on the card.

    python scripts/torch_k5_timing.py [--src DIR]

For the two shapes an evaluation gives it (8192 rays × 64 and × 192
samples) it checks the kernel against its plain version and prints the
kernel's own device time (torch.profiler; inputs warm, and cold after an L2
flush), the event time of a call of the Python wrapper, and the bytes bound
(every input read once, every output written once, at 3.35 TB/s). `--src
DIR` takes the package from DIR (the `src` directory of another checkout
of this repo, e.g. a `git archive` of an earlier commit unpacked under
`build/`), so that two versions of the kernel can be timed in one run on
one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import HBM_BPS, cuda_ms, device_ms, maxerr, nbytes  # noqa


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="the src directory to take fashion_nerf_torch from")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.kernels import render
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: K5 is timed on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"package {os.path.dirname(K.__file__)}; {smi}", flush=True)
    K.library()
    log = K.build_info.get("log", "").splitlines()
    for i, line in enumerate(log):          # ptxas on K5's kernel
        if "volrend_kernel" in line and "Compiling" in line:
            print("ptxas: " + " | ".join(x.strip() for x in log[i:i + 3]),
                  flush=True)
    rng = np.random.default_rng(0)
    for R, S in ((8192, 64), (8192, 192)):
        t = torch.from_numpy(np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1)
                             .astype(np.float32)).to(dev)
        sigma = torch.from_numpy(rng.normal(0.0, 20.0, (R, S)).astype(
            np.float32)).to(dev)
        rgb = torch.from_numpy(rng.uniform(0, 1, (R, S, 3)).astype(
            np.float32)).to(dev)
        dnorm = torch.from_numpy(rng.uniform(0.9, 1.2, R).astype(
            np.float32)).to(dev)
        a = (rgb, sigma, t, dnorm, True)
        out_k, out_p = render.volrend(*a), render.volrend_plain(*a)
        torch.cuda.synchronize()
        err = max(maxerr(x, y) for x, y in zip(out_k, out_p))
        bound = nbytes(rgb, sigma, t, dnorm, *out_k) / HBM_BPS * 1e3
        call = cuda_ms(lambda: render.volrend(*a))
        d = device_ms(lambda: render.volrend(*a), "volrend_kernel")
        print(f"K5 {R} rays × {S}: max abs err {err:.3g}; device "
              f"{d['cold']:.4f} ms cold, {d['warm']:.4f} ms warm; a call of "
              f"the wrapper {call:.4f} ms; bound {bound:.4f} ms (bytes), "
              f"{bound / d['cold']:.1%} of it reached cold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
