#!/usr/bin/env python3
"""Where the time of the Hopper kernels K1, K2, K3, K4, K6 and the probe
goes, on one GPU.

    PYTHONPATH=src python scripts/torch_march_breakdown.py \
        [--only march|field|carry|probe]

Builds variants of `csrc/sigmamarch.cu` and `csrc/slimmarch.cu` (the
marches) and of `csrc/field.cu` + `csrc/field_bwd.cu` with their shared
`csrc/wg_field.cuh` (the field and its backward) with one part of their
work taken out (the sines of the posenc operand, the layer wgmmas, the
weight ring's waits and copies, the epilogue's bias and x-term adds,
every work item; for the field also K4's workspace stores, wgrad's
wgmmas and the whole of wgrad; and two that undo K4's own settings: its
stores under L2's default policy, its ring at 3 slots), each by a text
substitution that must
apply to the source as it stands, into `build/march_breakdown/` (one nvcc
per variant, all started together). The marches are timed on an all-live
8192-ray chunk of random inputs at the main path's shapes (K1: 2×128
net, SB = 64; K2: 8×256 net, 3 blocks of 32, no termination); K3 and K4
at the training step's fine shape (a random 8×256 net, 4096 rays × 192
samples = 786,432 rows) through their wrappers with the variant's
library swapped in. CUDA events around back-to-back calls after one
warm-up (20 for the marches and K3, 5 for K4). The variants compute wrong
results and exist only to be timed. Also prints the real wrappers' time
and their kernels' device time under torch.profiler.

`--only carry` (K6: `csrc/carrymarch.cu` with `csrc/wg_field.cuh`) takes
out the layer wgmmas, the ring, the sines and the compositing, on the same
all-live chunk as K2 with a random 8×256 net. `--only probe`
(`csrc/tcprobe.cu`) takes out the wgmmas, the ring, the epilogue's stores
and the loads of x, cuts the ring from 5 slots to the field kernels' 3,
and makes the two consumer warpgroups take turns at the tensor cores
(named barriers around each column block's wgmmas; it needs the 5-slot
ring and two warpgroups, so it is timed on P1 only), on P1's chain+relu
(2^21 rows) and P2's w512 d9 dependent (2^20 rows). Both run through their
wrappers with the variant's library swapped in (20 calls; 5 for the
probe). Without `--only`, the marches and the field run.
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
from fashion_nerf_torch import probe  # noqa: E402
from fashion_nerf_torch.kernels import (carrymarch, posenc_mlp,  # noqa: E402
                                        sigmamarch, slimmarch, wgpack)
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
# the field kernels: substitutions in any file of csrc/ (wg_field.cuh is
# shared by K3 and K4, so one variant build times both)
FIELD = {
    "as built": [],
    "no layer wgmma": [
        ("  wg::mma_slice<N>(acc, a_addr, a_K, a_k, wg::smem_addr("
         "r.slot[rp.stage]), kk,\n                   zero);\n", "")],
    "no weight ring": [
        ("  wg::mbar_wait(&r.full[rp.stage], rp.phase);\n  wg::mma_fence();",
         "  wg::mma_fence();"),
        ("    release(r, rp.pend);\n  }\n  rp.pend", "  }\n  rp.pend"),
        ("  release(r, rp.pend);\n  rp.pend = -1;", "  rp.pend = -1;"),
        ("    for (int sl = 0; sl < n_slices; ++sl) {",
         "    for (int sl = 0; sl < 0; ++sl) {")],
    "no sines": [
        ("        v[e] = sinf(__fadd_rn(", "        v[e] = (__fadd_rn(")],
    "no workspace stores": [
        ("      wgf::bulk_store(dst, tile, cols * 64 * 2);\n", "")],
    "no wgrad wgmma": [
        ("        wg::mma_mn<N>(acc, wg::desc_mn(aa + (ks >> 3) * 2048, 2048, "
         "128),\n                      wg::desc_mn(da + (ks >> 3) * N * 16, "
         "N * 16, 128));", "        (void)aa, (void)da;")],
    "no wgrad": [
        ("      for (long kb = kb0; kb < kb1; ++kb) {\n        wg::mbar_wait",
         "      for (long kb = kb0; kb < kb0; ++kb) {\n        wg::mbar_wait"),
        ("  for (long kb = kb0; kb < kb1; ++kb) {\n    wg::mbar_wait",
         "  for (long kb = kb0; kb < kb0; ++kb) {\n    wg::mbar_wait")],
}
FIELD["no layer wgmma, no weight ring"] = (FIELD["no layer wgmma"]
                                           + FIELD["no weight ring"])
FIELD["no column sums"] = [
    ("float (&p)[16], float s0,\n"
     "                                            float s1) {\n",
     "float (&p)[16], float s0,\n"
     "                                            float s1) {\n  return;\n")]
FIELD["no posenc backward"] = [
    ("int tw, int bar) {\n#pragma unroll",
     "int tw, int bar) {\n  return;\n#pragma unroll")]
FIELD["no view column pass"] = [
    ("      for (int c = tw; c < kHalf; c += 128) {\n        const float* wr",
     "      for (int c = tw; c < 0; c += 128) {\n        const float* wr")]
# K4's rows kernel as it was before its workspace stores were marked
# evict_first and its ring took a fourth slot: the stores under L2's
# default policy, and the ring of 3
FIELD["stores without the L2 hint"] = [
    ('      "{\\n.reg .b64 policy;\\n"\n'
     '      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\\n"\n'
     '      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "\n'
     '      "[%0], [%1], %2, policy;\\n}\\n"',
     '      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"')]
FIELD["ring of 3 slots"] = [("constexpr int kStagesK4 = 4;",
                             "constexpr int kStagesK4 = 3;")]
# K6: the field's loop (wg_field.cuh) inside carrymarch.cu
CARRY = {
    "as built": [],
    "no layer wgmma": FIELD["no layer wgmma"],
    "no weight ring": FIELD["no weight ring"],
    "no sines": FIELD["no sines"],
    "no compositing": [("    if (ww < 2 / q) {", "    if (false) {")],
    "no layer wgmma, no weight ring": FIELD["no layer wgmma, no weight ring"],
}
# the probe: the same ring and consume, its own producer and epilogue
# ("no wgmma, no weight ring" is filled in below the table)
PROBE_RING = FIELD["no weight ring"][:3] + [
    ("    for (int ks = 0; ks < KS; ++ks) {\n      wg::mbar_wait(",
     "    for (int ks = 0; ks < 0; ++ks) {\n      wg::mbar_wait("),
    # the held chain's own copy of consume
    ("            wg::mbar_wait(&s.ring.full[rp.stage], rp.phase);\n", ""),
    ("              wgf::release(s.ring, rp.pend);\n", "")]
PROBE = {
    "as built": [],
    "no wgmma": FIELD["no layer wgmma"] + [
        ("              mma_rs_n256(acc, held[m], held[m + 1], held[m + 2], "
         "held[m + 3],\n", "              (void)(acc, held[m], held[m + 1], "
         "held[m + 2], held[m + 3],\n")],
    "no weight ring": PROBE_RING,
    # the stores sit behind a test that never holds, so the accumulators
    # stay live: with the epilogue's loop cut out instead, ptxas drops the
    # wgmmas whose results nobody reads and the variant runs faster than the
    # tensor cores could
    "no epilogue stores": [
        ("          wgf::st_pair(dst, rA, c, W, lo);\n"
         "          wgf::st_pair(dst, rA + 8, c, W, hi);",
         "          if (a.n < 0) wgf::st_pair(dst, rA, c, W, lo);\n"
         "          if (a.n < 0) wgf::st_pair(dst, rA + 8, c, W, hi);"),
        ("          if (live) {\n            *reinterpret_cast<float2*>(o_lo",
         "          if (live && a.n < 0) {\n"
         "            *reinterpret_cast<float2*>(o_lo")],
    "no loads of x": [
        ("        if (live)\n          v = *reinterpret_cast<const uint4*>",
         "        if (false)\n          v = *reinterpret_cast<const uint4*>")],
    "no wgmma, no weight ring": None,
    # the ring of the field kernels: the warpgroups can drift only two
    # slices apart, so their epilogues coincide
    "ring of 3 slots": [("constexpr int kDeepP = 5, kShallowP = 3;",
                         "constexpr int kDeepP = 3, kShallowP = 3;")],
    # the two warpgroups take turns at the tensor cores: one issues a
    # column block's wgmmas while the other runs its epilogue
    "ordered warpgroups": [
        ("  float acc[kColsP / 2];\n",
         "  float acc[kColsP / 2];\n"
         "  if (g == 1) asm volatile(\"bar.arrive 3, 256;\" ::: \"memory\");\n"),
        ("      if (kHold && step > 0) {\n",
         "      asm volatile(\"bar.sync %0, 256;\" ::\"r\"(3 + g) : "
         "\"memory\");\n"
         "      if (kHold && step > 0) {\n"),
        ("      wgf::drain(acc, rp, s.ring);\n      if constexpr (kHold)",
         "      asm volatile(\"bar.arrive %0, 256;\" ::\"r\"(4 - g) : "
         "\"memory\");\n"
         "      wgf::drain(acc, rp, s.ring);\n      if constexpr (kHold)"),
        ("    wg::wg_sync(bar);   // the tiles are free for the next item's "
         "rows\n  }\n",
         "    wg::wg_sync(bar);   // the tiles are free for the next item's "
         "rows\n  }\n"
         "  if (g == 0) asm volatile(\"bar.sync 3, 256;\" ::: \"memory\");\n")],
}
PROBE["no wgmma, no weight ring"] = PROBE["no wgmma"] + PROBE_RING


def _substitute(d: str, files: list, subs: list, what: str) -> None:
    """Apply every (old, new) to the first of `files` under d that holds
    old; raise if none does."""
    for a, b in subs:
        for f in files:
            path = os.path.join(d, f)
            text = open(path).read()
            if a in text:
                open(path, "w").write(text.replace(a, b))
                break
        else:
            raise RuntimeError(f"{what}: the sources no longer hold "
                               f"{a[:60]!r}")


def build_variants(only) -> dict:
    """→ {(kernel, variant): the variant's library (the field) or C entry
    point (the marches)}."""
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    tables = []
    if only in (None, "march"):
        tables += [("K1", ["sigmamarch.cu"], K1), ("K2", ["slimmarch.cu"], K2)]
    if only in (None, "field"):
        tables.append(("field", ["wg_field.cuh", "field.cu", "field_bwd.cu"],
                       FIELD))
    if only == "carry":    # field.cu: it defines fnt_error_string
        tables.append(("carry", ["wg_field.cuh", "carrymarch.cu", "field.cu"],
                       CARRY))
    if only == "probe":
        tables.append(("probe", ["wg_field.cuh", "tcprobe.cu", "field.cu"],
                       PROBE))
    todo = []
    for kern, files, table in tables:   # every substitution before any nvcc
        for i, (name, subs) in enumerate(table.items()):
            d = os.path.join(OUT, f"{kern}_{i}")
            shutil.copytree(K.CSRC, d)
            _substitute(d, files, subs, f"{kern} '{name}'")
            srcs = [os.path.join(d, f) for f in files if f.endswith(".cu")]
            todo.append(((kern, name), os.path.join(d, "lib.so"), srcs))
    for key, so, srcs in todo:
        cmd = [K._nvcc(), *K.NVCC_FLAGS[:-2], "-shared", "-o", so, *srcs]
        jobs.append((key, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for key, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(so)
        if key[0] in ("field", "carry", "probe"):
            for sym in ("fnt_field_forward", "fnt_field_backward",
                        "fnt_carry_march", "fnt_tc_probe"):
                if hasattr(lib, sym):
                    getattr(lib, sym).argtypes = K._SIGNATURES[sym]
                    getattr(lib, sym).restype = ctypes.c_int
            lib.fnt_error_string.argtypes = [ctypes.c_int]
            lib.fnt_error_string.restype = ctypes.c_char_p
            fns[key] = lib
            continue
        sym = "fnt_sigma_march" if key[0] == "K1" else "fnt_slim_march"
        fn = getattr(lib, sym)
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


def fine_net(rng, dev):
    W, cx = 256, 63
    return net(rng, dev, {
        **{f"trunk_{i}": ((cx + W) if i == 5 else (cx if i == 0 else W), W)
           for i in range(8)},
        "sigma_head": (W, 1), "feature": (W, W), "view_0": (W + 27, W // 2),
        "rgb_head": (W // 2, 3)})


def profile_ms(call, names, n: int = 5) -> float:
    """Device ms a call of the kernels whose names hold one of `names`."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if any(k in e.key for k in names)) / n / 1e3


def field_breakdown(fns, dev, smi) -> None:
    """K3 and K4 at the step's fine shape with each variant library."""
    rng = np.random.default_rng(1)
    R, S = 4096, 192
    n = R * S
    fnet = posenc_mlp.pack_params(fine_net(rng, dev), hoist_x=False)
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (n, 3)), dtype=torch.float32,
                       device=dev)
    dp = posenc_mlp.hoist_dirs(fnet, torch.tensor(
        rng.normal(size=(R, 3)), dtype=torch.float32, device=dev)).contiguous()
    g_rgb = torch.tensor(1e-4 * rng.normal(size=(n, 3)), dtype=torch.float32,
                         device=dev)
    g_sig = torch.tensor(1e-4 * rng.normal(size=n), dtype=torch.float32,
                         device=dev)
    k3 = lambda: posenc_mlp.field_rows(fnet, pts, dp, S)  # noqa: E731
    k4 = lambda: posenc_mlp.field_rows_backward(  # noqa: E731
        fnet, pts, dp, g_rgb, g_sig, S)
    print(f"{smi}; K3 and K4 on {n} rows ({R} rays × {S}), random 8×256 net")
    real = K.library()
    try:
        for (kern, name), lib in fns.items():
            if kern != "field":
                continue
            K._lib = lib
            ms3 = ms_per_call(k3)
            ms4 = ms_per_call(k4, 5)
            rows = profile_ms(k4, ("bwd_rows_kernel",), 2)
            wgrad = profile_ms(k4, ("wgrad_kernel",), 2)
            print(f"field {name:32s} K3 {ms3:.4f} ms; K4 {ms4:.4f} ms (rows "
                  f"kernel {rows:.4f}, wgrad {wgrad:.4f})")
    finally:
        K._lib = real
    print(f"K3 wrapper: kernel's device time "
          f"{profile_ms(k3, ('field_kernel',)):.4f} ms a call")


def _chunk(dev, R, NB, SB):
    """An all-live chunk: rays of a fan, NB·SB samples over [2, 6], thin
    intervals (no termination)."""
    ang = torch.linspace(-0.4, 0.4, R, device=dev)
    ro = torch.zeros((R, 3), device=dev)
    ro[:, 2] = 4.0
    rd = torch.stack([torch.sin(ang), 0.1 * torch.cos(3 * ang),
                      -torch.cos(ang)], dim=-1)
    S = NB * SB
    t = torch.linspace(2.0, 6.0, S, device=dev).expand(R, S).contiguous()
    d = torch.full((R, S), 4.0 / S / 10, device=dev)
    return (ro, rd, t, d, torch.ones(R, device=dev),
            torch.ones((R, NB), device=dev))


def _swapped(fns, kern, call, n, label, skip=()) -> None:
    """Time call() with each variant library of `kern` in place of the
    built one, but for the variants named in `skip`."""
    real = K.library()
    try:
        for (k, name), lib in fns.items():
            if k != kern or name in skip:
                continue
            K._lib = lib
            try:
                print(f"{label} {name:32s} {ms_per_call(call, n):.4f} ms a "
                      "call")
            except RuntimeError as e:   # a variant's tiles may not fit
                print(f"{label} {name:32s} refused: {e}")
    finally:
        K._lib = real


def carry_breakdown(fns, dev, smi) -> None:
    """K6 on the all-live chunk K2 is timed on, with each variant."""
    rng = np.random.default_rng(0)
    R, NB, SB = 8192, 3, 32
    model = fine_net(rng, dev)
    net = posenc_mlp.pack_params(model, hoist_x=False)
    ro, rd, t, d, hit, bhit = _chunk(dev, R, NB, SB)
    dp = posenc_mlp.hoist_dirs(net, rd).contiguous()
    call = lambda: carrymarch.carry_march(  # noqa: E731
        net, dp, ro, rd, hit, bhit, t, d, -6.9)
    print(f"{smi}; K6 on an all-live chunk of {R} rays × {NB}×{SB}, random "
          f"8×256 net: {R // 64 * NB} (tile, block) pairs")
    _swapped(fns, "carry", call, 20, "K6")
    snet = slimmarch.split_hoist(model)
    hf = slimmarch.hoist_rays(snet, ro, rd)
    ms2 = ms_per_call(lambda: slimmarch.slim_march(snet, hf, dp, hit, bhit,
                                                   t, d, -6.9))
    print(f"K6 wrapper: {ms_per_call(call):.4f} ms a call, kernels' device "
          f"time {profile_ms(call, ('carry_march_kernel',)):.4f} ms; K2 on "
          f"the same chunk {ms2:.4f} ms a call")


def probe_breakdown(fns, dev, smi) -> None:
    """P1's chain+relu and chain f32hold and P2's w512 d9 dependent with
    each variant."""
    for label, n, w, dep, mode, relu, scale in (
            ("P1 chain+relu w256 d9", probe.P1_ROWS, 256, 9, "chain", True,
             0.06),
            ("P1 chain f32hold w256 d9", probe.P1_ROWS, 256, 9, "hold", True,
             0.06),
            ("P2 w512 d9 dependent", probe.P2_ROWS, 512, 9, "dependent",
             False, 0.05)):
        x, ws = probe.make_inputs(n, w, dep, scale, 0, dev)
        print(f"{smi}; {label}, {n} rows")
        # one consumer warpgroup at width 512: nothing to take turns with
        _swapped(fns, "probe",
                 lambda: probe.tc_chain(x, ws, mode, relu), 5, label,
                 skip=("ordered warpgroups",) if w > 256 else ())
        del x, ws


def main() -> int:
    only = None
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fns = build_variants(only)
    if only in ("field", "carry", "probe"):
        {"field": field_breakdown, "carry": carry_breakdown,
         "probe": probe_breakdown}[only](fns, dev, smi)
        return 0
    rng = np.random.default_rng(0)
    R, NB, SB = 8192, 3, 32
    fine = slimmarch.split_hoist(fine_net(rng, dev))
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
        if kern == "field":
            continue
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
    if only is None:
        field_breakdown(fns, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
