#!/usr/bin/env python3
"""Times the port's field kernels (K3, K4) and volume render (K5) on the card.

    python scripts/torch_kernel_timing.py [--src DIR] [--only field|k4|k5]

`field`: on the committed flagship fine net with 64 cond rows of N(0,
0.01²) (chip_smoke.cond_tree, the `[tryon]` fixture's net) and on the same
net without them, K3 at the occupancy sweep's 65,536 rows (1024 rays × 64),
unconditioned and with its cond window, and K4 at the try-on step's fine
shape, 393,216 rows (2048 rays × 192), unconditioned and, where the package
has it, with its conditioned plan: median of 5 calls of the wrapper (CUDA
events).

`k4`: K4 on fixed seeded inputs, so that two versions can be held bitwise
equal and timed: the `fern.train.dense` step's two calls (llff_fern's 8×256
net, L = 10, skip (4,), with a view branch: 16,384 rays × 64 coarse and
× 192 fine rows), `chip_smoke.py` `[kernels]`'s shapes (the committed
flagship fine net at 786,432 rows, conditioned with TRYON_CC cond rows at
393,216; an 8×256 net with skips (2, 4) at both) and an 8×128 net with
skip (4,) at both. Weights, positions, view and cond terms and cotangents
come from numpy generators with fixed seeds. Each case prints the sha256 of
K4's outputs (d_pts, d_dirpart, d_w, d_b and, conditioned, d_condpart, as
bytes in that order), the median of 5 calls of the wrapper (CUDA events)
and its rows kernel's device time (torch.profiler, one call).

`k5`: for the two shapes an evaluation gives K5 (8192 rays × 64 and × 192
samples), the kernel against its plain version, its own device time
(torch.profiler; inputs warm, and cold after an L2 flush), the event time of
a call of the wrapper, and the bytes bound (every input read once, every
output written once, at 3.35 TB/s).

`--src DIR` takes the package from DIR (the `src` directory of another
checkout of this repo, e.g. a `git archive` of an earlier commit unpacked
under `build/`), so that two versions can be timed in turns in one run on
one card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (HBM_BPS, TRYON_CC, cond_tree, cuda_ms,  # noqa: E402
                        device_ms, maxerr, nbytes, skip_tree)


def time_field(dev, rng) -> None:
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.kernels import posenc_mlp
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    trained, _ = load_flagship()
    nets = {"unconditioned": load_flax_params(
        trained["fine"], compute_dtype="bfloat16", device=dev)}
    nets["conditioned"] = load_flax_params(
        cond_tree(trained["fine"], TRYON_CC, rng), compute_dtype="bfloat16",
        device=dev, cond_dim=TRYON_CC)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    for label, model in nets.items():
        net = posenc_mlp.pack_params(model, hoist_x=False)
        for kernel, R, S in (("K3", 1024, 64), ("K4", 2048, 192)):
            n = R * S
            pts = t(rng.uniform(-1.2, 1.2, (n, 3)))
            dp = posenc_mlp.hoist_dirs(net, t(rng.normal(size=(R, 3))))
            dp = dp.contiguous()
            cp = (posenc_mlp.hoist_cond(net, t(rng.normal(size=(
                R, TRYON_CC)))) if label == "conditioned" else None)
            extra = () if cp is None else (cp,)
            if kernel == "K3":
                def call():
                    return posenc_mlp.field_rows(net, pts, dp, S, *extra)
            else:
                g_rgb = t(1e-4 * rng.normal(size=(n, 3)))
                g_sig = t(1e-4 * rng.normal(size=n))

                def call():
                    return posenc_mlp.field_rows_backward(
                        net, pts, dp, g_rgb, g_sig, S, *extra)
            try:
                ms = cuda_ms(call)
            except NotImplementedError as e:
                print(f"{kernel} {label} {n} rows: not in this package "
                      f"({e})", flush=True)
                continue
            print(f"{kernel} {label} {n} rows ({R} rays × {S}): {ms:.4f} ms "
                  "(median of 5)", flush=True)
            torch.cuda.empty_cache()


def k4_cases():
    """→ [(label, tree, cond rows, rays, samples a ray)], trees as numpy."""
    from fashion_nerf_torch.assets import load_flagship
    trained, _ = load_flagship()
    rng = np.random.default_rng(2301)
    fern = skip_tree(rng, W=256, L=10, depth=8, skips=(4,))
    two = skip_tree(rng, W=256, L=10, depth=8, skips=(2, 4))
    two_c = skip_tree(rng, W=256, L=10, depth=8, skips=(2, 4), cc=TRYON_CC)
    w128 = skip_tree(rng, W=128, L=10, depth=8, skips=(4,))
    w128_c = skip_tree(rng, W=128, L=10, depth=8, skips=(4,), cc=TRYON_CC)
    flag_c = cond_tree(trained["fine"], TRYON_CC, rng)
    return [
        ("fern.train.dense coarse, 8×256 skip (4,)", fern, 0, 16384, 64),
        ("fern.train.dense fine, 8×256 skip (4,)", fern, 0, 16384, 192),
        ("[kernels] flagship fine", trained["fine"], 0, 4096, 192),
        ("[kernels] flagship fine, conditioned", flag_c, TRYON_CC, 2048, 192),
        ("[kernels] 8×256 skips (2, 4)", two, 0, 4096, 192),
        ("[kernels] 8×256 skips (2, 4), conditioned", two_c, TRYON_CC, 2048,
         192),
        ("8×128 skip (4,)", w128, 0, 4096, 192),
        ("8×128 skip (4,), conditioned", w128_c, TRYON_CC, 2048, 192),
    ]


def time_k4(dev) -> None:
    from torch.profiler import ProfilerActivity, profile

    from fashion_nerf_torch.kernels import posenc_mlp
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    for i, (label, tree, cc, R, S) in enumerate(k4_cases()):
        rng = np.random.default_rng(7000 + i)
        net = posenc_mlp.pack_params(load_flax_params(
            tree, compute_dtype="bfloat16", device=dev,
            **({"cond_dim": cc} if cc else {})), hoist_x=False)
        n = R * S

        def t(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)
        pts = t(rng.uniform(-1.2, 1.2, (n, 3)))
        dp = posenc_mlp.hoist_dirs(net, t(rng.normal(size=(R, 3))))
        cp = (posenc_mlp.hoist_cond(net, t(rng.normal(size=(R, cc))))
              if cc else None)
        args = (net, pts, dp.contiguous(), t(1e-4 * rng.normal(size=(n, 3))),
                t(1e-4 * rng.normal(size=n)), S, cp)

        def call():
            return posenc_mlp.field_rows_backward(*args)
        h = hashlib.sha256()
        for x in call():
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        ms = cuda_ms(call)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        rows = sum(e.device_time_total for e in prof.key_averages()
                   if "bwd_rows_kernel" in e.key) / 1e3
        print(f"K4 {label}: {n} rows ({R} rays × {S}), sha256 "
              f"{h.hexdigest()[:16]}; {ms:.4f} ms a call (median of 5), rows "
              f"kernel {rows:.4f} ms", flush=True)
        del net, pts, dp, cp, args
        torch.cuda.empty_cache()


def time_k5(dev, rng, K) -> None:
    from fashion_nerf_torch.kernels import render
    log = K.build_info.get("log", "").splitlines()
    for i, line in enumerate(log):          # ptxas on K5's kernel
        if "volrend_kernel" in line and "Compiling" in line:
            print("ptxas: " + " | ".join(x.strip() for x in log[i:i + 3]),
                  flush=True)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="the src directory to take fashion_nerf_torch from")
    ap.add_argument("--only", choices=("field", "k4", "k5"), default=None,
                    help="time only the field kernels, K4's hashed cases "
                    "or K5")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    from fashion_nerf_torch import kernels as K
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels are timed on the "
                           "card")
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"package {os.path.dirname(K.__file__)}; {smi}", flush=True)
    K.library()
    rng = np.random.default_rng(0)
    if args.only in (None, "field"):
        time_field(dev, rng)
    if args.only in (None, "k4"):
        time_k4(dev)
    if args.only in (None, "k5"):
        time_k5(dev, rng, K)
    return 0


if __name__ == "__main__":
    sys.exit(main())
