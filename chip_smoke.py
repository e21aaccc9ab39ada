#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives the port's main path once, as `python -m fashion_nerf_torch.bench`
does: the 800×800 `blender_lego` frame with the committed trained weights,
the occupancy sweep and the committed proposal net. Phases, in order:

1. device: name, power limit, TF32 off;
2. build: nvcc builds the kernels from src/fashion_nerf_torch/kernels/csrc;
3. kernels: K3 (fused field), K1 (proposal march) and K2 (fine march) each
   against its plain PyTorch version on the card, at main-path shapes;
4. setup: flagship + proposal asset, occupancy sweep through K3;
5. frame: the frame through the kernels (1 warm-up + 3 timed), then through
   the plain versions; PSNR between them and non-trivial-image checks.

The launch counters are reset just before phase 4 and read right after the
timed frames, so they count the main path only. Any failure raises (non-zero
exit). Imports nothing of JAX. The last line is the device JSON object.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# tolerances of the kernel checks (tests/test_torch_kernels_plain.py holds
# the plain versions to the reference with the same atols). K3 on the
# trained net: one bf16 rounding flip moves rgb by up to ~0.04 on a few rows
# (f32 vs f64 summation of the same products: 0.042 max, 0.19% of rows over
# 5e-3), so rgb ≤ 5e-3 on all but a share of rows and ≤ 5e-2 everywhere.
# The share is 1% here (0.5% against the reference on the CPU): the tensor
# cores sum in another order than cuBLAS's f32 GEMM (measured 0.43% on NVIDIA
# H100 80GB HBM3 at a 700 W power limit).
K3_RGB_ATOL, K3_ROW_SHARE, K3_RGB_MAX = 5e-3, 1e-2, 5e-2
K3_SIGMA_REL = 2e-2           # σ within 2e-2·(1 + |σ|)
K1_ATOL = 2e-3                # weights and acc
K2_ATOL = 5e-2                # rgb and weights on the trained fine net
FRAME_PSNR_MIN = 40.0
REPS = 5                      # timed calls per kernel (median)
FRAME = 800                   # frame height and width of the bench

SOURCES = {
    "field": ("src/fashion_nerf_torch/kernels/csrc/field.cu",
              "src/fashion_nerf/kernels/posenc_mlp_pallas.py:279"),
    "sigma_march": ("src/fashion_nerf_torch/kernels/csrc/sigmamarch.cu",
                    "src/fashion_nerf/kernels/sigmamarch_pallas.py:91"),
    "slim_march": ("src/fashion_nerf_torch/kernels/csrc/slimmarch.cu",
                   "src/fashion_nerf/kernels/slimmarch_pallas.py:113"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of fn() on the card (CUDA events), after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return name, smi


def phase_build():
    from fashion_nerf_torch import kernels as K
    path = K.build()
    K.library()
    info = K.build_info
    say("build", f"{path.name} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say("build", "ptxas: " + line.strip())


def random_tree(tree, rng):
    """A parameter tree shaped like `tree` with LeCun-normal kernels and
    small random biases, drawn from rng."""
    out = {}
    for name, leaf in tree["params"].items():
        k = leaf["kernel"]
        out[name] = {
            "kernel": (rng.normal(size=k.shape) / np.sqrt(k.shape[0])
                       ).astype(np.float32),
            "bias": (0.1 * rng.normal(size=leaf["bias"].shape)
                     ).astype(np.float32)}
    return {"params": out}


def chunk_inputs(cfg, occ, device):
    """Rays of one 8192-ray chunk of the bench frame (tile order) that has
    both live and dead proposal tiles, with its culling state."""
    from fashion_nerf_torch.bench import bench_pose
    from fashion_nerf_torch.core.cameras import generate_rays
    from fashion_nerf_torch.render.blockwise import _tile_order, culling
    from fashion_nerf_torch import kernels as K
    H = W = FRAME
    focal, c2w = bench_pose(W)
    o, d = generate_rays(H, W, focal, c2w, device=device)
    order = torch.from_numpy(_tile_order(H, W)[0]).to(device)
    o, d = o.reshape(-1, 3)[order], d.reshape(-1, 3)[order]
    chunk = cfg.render.chunk
    rpt = K.TILE_ROWS // cfg.proposal.block_samples
    best, best_live = None, -1
    for c in range(o.shape[0] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        _, _, alive0, _, _ = culling(cfg, o[sl], d[sl], occ)
        tiles = alive0.view(-1, rpt).any(dim=1)
        n_live = int(tiles.sum())
        if n_live < tiles.numel() and n_live > best_live:
            best, best_live = c, n_live
    if best is None:
        raise RuntimeError("no chunk with both live and dead tiles")
    sl = slice(best * chunk, (best + 1) * chunk)
    return best, o[sl].contiguous(), d[sl].contiguous()


def phase_kernels(cfg, device):
    """Each kernel against its plain version at main-path shapes."""
    from fashion_nerf.assets import load_flagship
    from fashion_nerf_torch.core.occupancy import build_from_config
    from fashion_nerf_torch.core.sampling import stratified_sample
    from fashion_nerf_torch.kernels import posenc_mlp, sigmamarch, slimmarch
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.models.proposal import attach_proposal
    from fashion_nerf_torch.render.blockwise import (_block_hit_flags,
                                                     _budgets, _pass_dists,
                                                     culling, fine_samples)
    results = {}
    trained, _ = load_flagship()
    fine = load_flax_params(trained["fine"], compute_dtype="bfloat16",
                            device=device)
    params = attach_proposal(cfg, {"fine": fine}, device=device)
    rng = np.random.default_rng(0)

    # K3: one 65,536-row sweep chunk (1024 rays × 64 samples)
    net = posenc_mlp.pack_params(fine, hoist_x=False)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (65536, 3)).astype(
        np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(1024, 3)).astype(
        np.float32)).to(device)
    dirpart = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dirpart, 64)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dirpart, 64)
    torch.cuda.synchronize()
    row_err = (rgb_k - rgb_p).abs().amax(dim=1)
    e_rgb = float(row_err.max())
    share = float((row_err > K3_RGB_ATOL).float().mean())
    e_sig = float(((sig_k - sig_p).abs() / (1 + sig_p.abs())).max())
    ok = (e_rgb <= K3_RGB_MAX and share <= K3_ROW_SHARE
          and e_sig <= K3_SIGMA_REL and bool(torch.isfinite(rgb_k).all()))
    ms = cuda_ms(lambda: posenc_mlp.field_rows(net, pts, dirpart, 64))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_plain(net, pts, dirpart, 64))
    say("kernels", f"K3 field 65536 rows: rgb err max {e_rgb:.3g} (tol "
        f"{K3_RGB_MAX}), rows over {K3_RGB_ATOL} {share:.5f} (tol "
        f"{K3_ROW_SHARE}), σ rel err {e_sig:.3g} (tol {K3_SIGMA_REL}); "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if not ok:
        raise AssertionError("K3 disagrees with its plain version")
    results["field"] = dict(max_abs_err=e_rgb, ms=ms, plain_ms=pms)

    # K3 on a random net of the same shape: no trained sensitivity, so the
    # strict bound holds on every row
    rnd = load_flax_params(random_tree(trained["fine"], rng),
                           compute_dtype="bfloat16", device=device)
    rnet = posenc_mlp.pack_params(rnd, hoist_x=False)
    rdp = posenc_mlp.hoist_dirs(rnet, dirs).contiguous()
    (rgb_k, sig_k), (rgb_p, sig_p) = (
        posenc_mlp.field_rows(rnet, pts, rdp, 64),
        posenc_mlp.field_rows_plain(rnet, pts, rdp, 64))
    e_rnd = maxerr(rgb_k, rgb_p)
    e_rsig = float(((sig_k - sig_p).abs() / (1 + sig_p.abs())).max())
    say("kernels", f"K3 field, random net: rgb err {e_rnd:.3g} (tol "
        f"{K3_RGB_ATOL} on every row), σ rel err {e_rsig:.3g}")
    if not (e_rnd <= K3_RGB_ATOL and e_rsig <= K3_SIGMA_REL):
        raise AssertionError("K3 disagrees with its plain version (random)")

    # reference occupancy through the plain field, for realistic chunk
    # inputs (and to check the K3 sweep of phase 4 against)
    field_plain = posenc_mlp.make_fused_field(cfg, plain=True)
    with torch.no_grad():
        occ_ref = build_from_config(
            cfg, lambda p, v: field_plain(fine, p, v), device=device)
    c, o, d = chunk_inputs(cfg, occ_ref, device)
    R = o.shape[0]
    n_prop, p_sb, n_fine = _budgets(cfg, occ_ref)

    # K1: the chunk's proposal march, 8192 rays × 64 samples
    near, far, alive0, seg, t_end = culling(cfg, o, d, occ_ref)
    dnorm = torch.linalg.norm(d, dim=-1, keepdim=True)
    t_c = stratified_sample(near, far, R, n_prop, device=device)
    t_pad, d_pad = _pass_dists(t_c, dnorm, t_end, p_sb)
    alive = (alive0.float() * _block_hit_flags(t_pad, p_sb, seg, R, 1)[:, 0]
             ).contiguous()
    prop = sigmamarch.pack_sigma(params["proposal"])
    hz = sigmamarch.hoist_rays(prop, o, d)
    args1 = (prop, hz, alive, t_pad.contiguous(), d_pad.contiguous())
    w_k, acc_k, _ = sigmamarch.sigma_march(*args1)
    w_p, acc_p, _ = sigmamarch.sigma_march_plain(*args1)
    torch.cuda.synchronize()
    e1 = max(maxerr(w_k, w_p), maxerr(acc_k, acc_p))
    rpt1 = 2048 // p_sb
    dead1 = int((~(alive.view(-1, rpt1) > 0).any(dim=1)).sum())
    ms = cuda_ms(lambda: sigmamarch.sigma_march(*args1))
    pms = cuda_ms(lambda: sigmamarch.sigma_march_plain(*args1))
    say("kernels", f"K1 sigma march chunk {c} ({R} rays × {p_sb}): "
        f"w/acc err {e1:.3g} (tol {K1_ATOL}); dead tiles {dead1}/"
        f"{R // rpt1}; kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if not (e1 <= K1_ATOL and dead1 > 0):
        raise AssertionError("K1 disagrees with its plain version")
    results["sigma_march"] = dict(max_abs_err=e1, ms=ms, plain_ms=pms)

    # K2: the chunk's fine march, 8192 rays × 96 samples, NB = 3
    SB = cfg.kernels.block_samples
    t_all = fine_samples(cfg, t_c, w_p, n_fine)
    alive_f = alive0 & (acc_p > cfg.proposal.cull_acc)
    tf_pad, df_pad = _pass_dists(t_all, dnorm, t_end, SB)
    NB = tf_pad.shape[1] // SB
    bhit = _block_hit_flags(tf_pad, SB, seg, R, NB).contiguous()
    fnet = slimmarch.split_hoist(fine)
    hf = slimmarch.hoist_rays(fnet, o, d)
    dp = posenc_mlp.hoist_dirs(fnet, d).contiguous()
    log_eps = math.log(cfg.kernels.early_term_eps)
    args2 = (fnet, hf, dp, alive_f.float().contiguous(), bhit,
             tf_pad.contiguous(), df_pad.contiguous(), log_eps)
    rgb_k, wf_k, lt_k = slimmarch.slim_march(*args2)
    rgb_p, wf_p, lt_p = slimmarch.slim_march_plain(*args2)
    torch.cuda.synchronize()
    e2 = max(maxerr(rgb_k, rgb_p), maxerr(wf_k, wf_p))
    rpt2 = 2048 // SB
    cand = (alive_f.float()[:, None] * bhit).view(-1, rpt2, NB)
    dead2 = int((cand.amax(dim=1) == 0).sum())
    term = int((lt_p < log_eps).sum())
    ms = cuda_ms(lambda: slimmarch.slim_march(*args2))
    pms = cuda_ms(lambda: slimmarch.slim_march_plain(*args2))
    say("kernels", f"K2 fine march chunk {c} ({R} rays × {NB}×{SB}): "
        f"rgb/w err {e2:.3g} (tol {K2_ATOL}); dead (tile, block) ≥ {dead2}/"
        f"{R // rpt2 * NB}; terminated rays {term}; kernel {ms:.3f} ms, "
        f"plain {pms:.3f} ms")
    if not (e2 <= K2_ATOL and dead2 > 0 and term > 0
            and bool(torch.isfinite(rgb_k).all())):
        raise AssertionError("K2 disagrees with its plain version")
    results["slim_march"] = dict(max_abs_err=e2, ms=ms, plain_ms=pms)
    return results, occ_ref


def phase_setup(cfg, device, occ_ref):
    from fashion_nerf_torch.bench import setup
    params, occ, secs = setup(cfg, device)
    agree = float((occ.grid == occ_ref.grid).float().mean())
    n_occ = int(occ.boxes_occ.sum())
    say("setup", f"occupancy 64³ through K3 + proposal asset in {secs:.3f} s"
        f"; box {occ.box_min.tolist()} .. {occ.box_max.tolist()}; occupied "
        f"macro boxes {n_occ}/{occ.boxes_occ.numel()}; grid agreement with "
        f"the plain field {agree:.5f}")
    if "proposal" not in params or agree < 0.999 or n_occ == 0:
        raise AssertionError("setup failed")
    return params, occ


def phase_frame(cfg, device, params, occ, gpu, smi):
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.bench import bench_pose
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    H = W = FRAME
    focal, c2w = bench_pose(W)

    def render(plain=False):
        with torch.no_grad():
            return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                          occ=occ, plain=plain,
                                          device=device)

    render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = render()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    launches = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    ref = render(plain=True)
    torch.cuda.synchronize()
    dt_plain = time.perf_counter() - t0

    rgb, acc, live = out["rgb"], out["acc"], out["chunk_live"]
    p = float(psnr(rgb, ref["rgb"]))
    corners = rgb[[0, 0, -1, -1], [0, -1, 0, -1]]
    n_chunks = -(-H * W // cfg.render.chunk)
    n_live = launches["sigma_march"] // 4     # one K1 launch per live chunk
    say("frame", f"{H}x{W}: {dt:.4f} s/frame through the kernels "
        f"({H * W / dt:.1f} rays/s), plain versions {dt_plain:.4f} s; "
        f"PSNR kernel vs plain {p:.2f} dB; centre acc "
        f"{float(acc[H // 2, W // 2]):.4f}; live chunks {n_live}/{n_chunks};"
        f" launches {launches}; {gpu} | {smi}")
    checks = {
        "launches": all(v > 0 for v in launches.values()),
        "psnr": p >= FRAME_PSNR_MIN,
        "shape_finite": (tuple(rgb.shape) == (H, W, 3)
                         and bool(torch.isfinite(rgb).all())),
        "centre": float(acc[H // 2, W // 2]) > 0.5,
        "corners": bool(((corners - 1.0).abs() <= 1e-6).all()),
        "live_and_dead": bool(live.any()) and not bool(live.all()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"frame checks failed: {failed}")
    return launches, dict(frame_s=dt, plain_frame_s=dt_plain, psnr=p)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "main path needs a CUDA device", file=sys.stderr)
        return 2
    from fashion_nerf.config import load_config
    from fashion_nerf_torch import kernels as K

    torch.set_grad_enabled(False)
    gpu, smi = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    cfg = load_config("blender_lego")
    results, occ_ref = phase_kernels(cfg, device)
    K.reset_launches()
    params, occ = phase_setup(cfg, device, occ_ref)
    launches, _ = phase_frame(cfg, device, params, occ, gpu, smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **results[name]} for name in ("sigma_march", "slim_march",
                                       "field")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
