#!/usr/bin/env python3
"""Where the time of the Hopper marches K1 and K2 goes, on one GPU.

    PYTHONPATH=src python scripts/torch_march_breakdown.py

Builds variants of `csrc/sigmamarch.cu` and `csrc/slimmarch.cu` with one
part of their work taken out (the sines of the posenc operand, the
wgmmas, the weight ring's waits and copies, the epilogue's bias and
x-term adds, every work item), each by a text substitution that must
apply to the source as it stands, into `build/march_breakdown/` (one nvcc
per variant, all started together), and times each on an all-live
8192-ray chunk of random inputs at the main path's shapes (K1: 2×128
net, SB = 64; K2: 8×256 net, 3 blocks of 32, no termination): CUDA events
around 20 back-to-back calls after one warm-up. The variants compute
wrong results and exist only to be timed. Also prints the real wrappers'
time and their kernels' device time under torch.profiler.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fashion_nerf_torch import kernels as K  # noqa: E402
from fashion_nerf_torch.kernels import (posenc_mlp, sigmamarch,  # noqa: E402
                                        slimmarch, wgpack)
from fashion_nerf_torch.models.nerf_mlp import load_flax_params  # noqa: E402

OUT = os.path.join(ROOT, "build", "march_breakdown")
NO_SIN = [("if (c < n_ph) v0 = sinf(", "if (c < n_ph) v0 = ("),
          ("        v1 = sinf(", "        v1 = (")]
K2 = {
    "as built": [],
    "no bias/x adds": [
        ("        const float b0 = bl[c], b1 = bl[c + 1];\n        float v[4]",
         "        const float b0 = 0.f, b1 = 0.f;\n        float v[4]"),
        ("        if (xlayer) {\n          const float o0 = ox[c]",
         "        if (false) {\n          const float o0 = ox[c]")],
    "no weight ring": [
        ("  wg::mbar_wait(&s.full[rp.stage], rp.phase);\n  wg::mma_fence();",
         "  wg::mma_fence();"),
        ("    release(s, rp.pend);\n  }\n  rp.pend", "  }\n  rp.pend"),
        ("  release(s, rp.pend);\n  rp.pend = -1;", "  rp.pend = -1;"),
        ("        for (int sl = 0; sl < a.n_slices; ++sl) {",
         "        for (int sl = 0; sl < 0; ++sl) {")],
    "no sines": NO_SIN,
    "no wgmma": [
        ("  wg::mma_slice<N>(acc, a_addr, a_K, a_k, wg::smem_addr("
         "s.ring[rp.stage]),\n                   kk, zero);", "")],
}
K2["no weight ring, no wgmma"] = K2["no weight ring"] + K2["no wgmma"]
K1 = {
    "as built": [],
    "no sines": NO_SIN,
    "no wgmma": [
        ("          wg::mma_slice<kW1>(acc, h_addr, kW1, k, w_addr + woff,\n"
         "                             wg::kSliceK, k == 0);", ""),
        ("        wg::mma_slice<kW1>(acc, a0_addr, k0, 0, w_addr + woff, k0,"
         " true);", "")],
    "no work items": [
        ("  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {",
         "  for (int it = blockIdx.x; it < 0; it += gridDim.x) {")],
}
K1["no sines, no wgmma"] = K1["no sines"] + K1["no wgmma"]


def build_variants() -> dict:
    """→ {(kernel, variant): the variant's C entry point}."""
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for kern, src, table in (("K1", "sigmamarch.cu", K1),
                             ("K2", "slimmarch.cu", K2)):
        for i, (name, subs) in enumerate(table.items()):
            d = os.path.join(OUT, f"{kern}_{i}")
            shutil.copytree(K.CSRC, d)
            path = os.path.join(d, src)
            text = open(path).read()
            for a, b in subs:
                if a not in text:
                    raise RuntimeError(f"{kern} '{name}': the source no "
                                       f"longer holds {a[:60]!r}")
                text = text.replace(a, b)
            open(path, "w").write(text)
            so = os.path.join(d, "lib.so")
            cmd = [K._nvcc(), *K.NVCC_FLAGS[:-2], "-shared", "-o", so, path]
            jobs.append(((kern, name), so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for key, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log[-4000:]}")
        sym = "fnt_sigma_march" if key[0] == "K1" else "fnt_slim_march"
        fn = getattr(ctypes.CDLL(so), sym)
        fn.argtypes = K._SIGNATURES[sym]
        fns[key] = fn
    return fns


def net(rng, dev, shapes):
    return load_flax_params({"params": {
        name: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
            np.float32), "bias": (0.1 * rng.normal(size=o)).astype(
            np.float32)} for name, (i, o) in shapes.items()}},
        compute_dtype="bfloat16").to(dev)


def ms_per_call(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fns = build_variants()
    rng = np.random.default_rng(0)
    R, NB, SB, W = 8192, 3, 32, 256
    cx = 63
    fine = slimmarch.split_hoist(net(rng, dev, {
        **{f"trunk_{i}": ((cx + W) if i == 5 else (cx if i == 0 else W), W)
           for i in range(8)},
        "sigma_head": (W, 1), "feature": (W, W), "view_0": (W + 27, W // 2),
        "rgb_head": (W // 2, 3)}))
    prop = sigmamarch.pack_sigma(net(rng, dev, {
        "trunk_0": (39, 128), "trunk_1": (128, 128), "out_head": (128, 4)}))
    ang = torch.linspace(-0.4, 0.4, R, device=dev)
    ro = torch.zeros((R, 3), device=dev)
    ro[:, 2] = 4.0
    rd = torch.stack([torch.sin(ang), 0.1 * torch.cos(3 * ang),
                      -torch.cos(ang)], dim=-1)
    S = NB * SB
    t2 = torch.linspace(2.0, 6.0, S, device=dev).expand(R, S).contiguous()
    d2 = torch.full((R, S), 4.0 / S / 10, device=dev)
    hit, bhit = torch.ones(R, device=dev), torch.ones((R, NB), device=dev)
    hf = slimmarch.hoist_rays(fine, ro, rd)
    dp = posenc_mlp.hoist_dirs(fine, rd).contiguous()
    t1 = torch.linspace(2.0, 6.0, 64, device=dev).expand(R, 64).contiguous()
    d1 = torch.full((R, 64), 0.01, device=dev)
    hz = sigmamarch.hoist_rays(prop, ro, rd)
    wp1, wp2 = wgpack.march_buffer(prop), wgpack.march_buffer(fine)
    w1, acc1, lt1 = (torch.empty_like(d1), torch.empty(R, device=dev),
                     torch.empty(R, device=dev))
    rgb2, w2 = torch.empty((R, 3), device=dev), torch.empty_like(t2)
    carry = [torch.zeros(R, device=dev) for _ in range(2)]

    def k1(fn):
        ptrs = [x.data_ptr() for x in (hit, *hz[2:], *hz[:2], t1, d1,
                                       prop.w, wp1, prop.b, w1, acc1, lt1)]
        assert fn(*ptrs, R, 64, prop.L, prop.depth, prop.width, prop.k0, 0,
                  wp1.numel(), K.stream()) == 0

    def k2(fn):
        for b in range(NB):
            ptrs = [x.data_ptr() for x in (
                hit, bhit, *hf[2:], *hf[:2], dp, t2, d2, fine.w, wp2,
                fine.b, rgb2, w2, carry[b % 2], carry[(b + 1) % 2])]
            assert fn(*ptrs, R, NB, SB, b, fine.L, fine.depth, fine.width,
                      fine.k0, fine.skip, 0, -6.9, K.stream()) == 0

    print(f"{smi}; all-live chunk of {R} rays: K1 {R // 32} tiles × 64 "
          f"samples, K2 {R // 64 * NB} (tile, block) pairs")
    for (kern, name), fn in fns.items():
        ms = ms_per_call(lambda: (k1 if kern == "K1" else k2)(fn))
        print(f"{kern} {name:28s} {ms:.4f} ms a call")
    for label, call in (
            ("K1 wrapper", lambda: sigmamarch.sigma_march(prop, hz, hit, t1,
                                                          d1)),
            ("K2 wrapper", lambda: slimmarch.slim_march(
                fine, hf, dp, hit, bhit, t2, d2, -6.9))):
        ms = ms_per_call(call)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        dev_ms = sum(e.device_time_total for e in prof.key_averages()
                     if "march_kernel" in e.key) / 10 / 1e3
        print(f"{label}: {ms:.4f} ms a call, kernels' device time "
              f"{dev_ms:.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
