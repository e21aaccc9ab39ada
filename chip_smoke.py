#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU, or on each of several:
`python3 chip_smoke.py`.

Drives the port's paths once each, as a user would call them: the
800×800 `blender_lego` frame (`python -m fashion_nerf_torch.bench`: the
committed trained weights, the occupancy sweep and the committed proposal
net), the same frame through the generic carry march
(`kernels.carry_hoist=false`), through the two-stage march
(`kernels.fused_carry=false`) and through the generic proposal march
(`proposal.sigma_march=false`), the 7-pose quality gate through both
marches (`python -m fashion_nerf_torch.quality --gate`), the same frame
under the last blockwise branches (`proposal.cov_n`, `proposal.union`,
`occupancy.sample_warp`) and with the spec sweep's wider proposals
distilled on the card, the `blender_lego`
trainer at full width (`train()`, from random init), the same trainer on a
width-32 net, which the field kernels run zero-padded, the tensor-core
probe (`python -m fashion_nerf_torch.probe [--shapes]`), the command line,
distribution (two ranks on the card: the dp=2 and tp=2 steps, `train`
under `torch.distributed.run`, the segmented ray scan, the dp-sharded
render and the `data.stream` prefetch; one rank a card over NCCL, across
every card the machine has), `llff_fern` end to end, and try-on
serving and training. Phases, in order:

1. device: name, power limit, TF32 off;
2. build: nvcc builds the kernels from src/fashion_nerf_torch/kernels/csrc,
   one process per source, all started together;
3. kernels: K3 (fused field, at the sweep's and the training step's
   shapes; the trained net at the step's 786,432 rows against an f64
   truth of the same bf16 weights and inputs, beside the plain version), K3 and K4 on nets of width 32 and 64, which run zero-padded,
   K3 with its tile-skip flag at the two-stage march's block (1,048,576
   rows, all tiles live and every other tile dead), K1 (proposal march),
   K2 (fine march), K2 without a view branch on the proposal net (also
   against K1), K6 (generic carry march, also against K2), K4 (field backward, twice: bitwise deterministic;
   its rows kernel and its wgrad + sums timed apart under torch.profiler,
   beside torch.matmul's time for the same wgrad products as a yardstick
   and the workspace's bytes as a floor), K5 (volume render) and the
   probe's chains (P1, P2), each against its plain PyTorch version on the
   card at main-path shapes, with its bound (the least time the card could
   take for the work) and the share of it reached; K1, K2 and K6 with
   their executed tiles or (tile, block) pairs identical to the plain
   version's; K1 and K5, whose calls are short, with the kernel's own
   device time (torch.profiler, inputs warm and after an L2 flush) beside
   the event time of a call of the wrapper; then the repaired shapes at
   full width on random nets: an 8×256 L = 10 field with skips (2, 4)
   (layers 3 and 5 take γ(x); its layout checked against the library's
   fnt_layout) through K3 (also with a 64-wide cond, n_cond 3), K4
   (786,432 rows; conditioned 393,216), K2 and K6 at the fine march's
   chunk; K2 with a view branch on an 8×128 net, K4 on it (786,432 rows;
   conditioned, n_cond 2, 393,216); the σ march at the
   sweep's 2×192 and 3×256 L = 8 proposals, which K2 without a view branch
   serves zero-padded to 256 (counted under "sigma_march_k2"); K8 (the
   occupancy culling against the 512 macro boxes) at the orbit cell's
   65,536-ray chunk, box_cull and block_hit at NB 1 and 3, equal to its
   plain versions, with the plain composition's time as library_ms;
4. setup: flagship + proposal asset, occupancy sweep through K3;
5. frame: the frame through the kernels (1 warm-up + 3 timed), then through
   the plain versions; PSNR between them and non-trivial-image checks; K8's
   launches, one box_cull and two block_hit a live chunk;
6. frame-generic: the same frame with `kernels.carry_hoist=false` (K1 +
   K6), against its plain frame and against the K2 frame of phase 5;
   frame-twostage: with `kernels.fused_carry=false` (one K3 launch with
   tile flags a sample block, for the proposal and the fine march; each
   march's alive_frac), against its plain frame and the K2 frame;
   frame-propmarch: with `proposal.sigma_march=false` (K2 without a view
   branch in place of K1), against its plain frame and the K1 + K2 frame;
7. gate: the 7-pose gate at 800×800 for the shipped preset and for
   `kernels.carry_hoist=false`, each pose's delta held to the reference's;
   branches: the bench frame under `proposal.cov_n=16`,
   `proposal.union=true`, `occupancy.sample_warp=true`, the 2×192 and
   3×256 L = 8 proposals (distilled on the card, 1500 steps), and the warp
   through K6 and the two-stage march: each 1 warm-up + 3 timed frames,
   ≥ 40 dB against its plain frame (the last two also against the K1 + K2
   warp frame), and its GT-minus-dense delta at the bench pose (the
   gate's references) beside the shipped preset's;
   frame-sb: the bench frame at SBs outside 16–64, each 1 warm-up + 3
   timed frames, ≥ 40 dB against its plain frame and against the K1 + K2
   frame: `kernels.block_samples=128` (the 96 fine samples padded to one
   block of 128) and `=8` (12 blocks), the σ march at
   `proposal.block_samples=128 proposal.eval_n=128` (K1 at 128), and K1 +
   K6 at `kernels.block_samples=128` (`kernels.carry_hoist=false`);
   sweep: the reference's spec sweep (`quality.run_sweep`, every row of
   scripts/quality_check.py) at 800×800 at the bench pose through the
   kernels: each row's PSNR against the GT and the dense row, its delta
   and seconds, each proposal row's student against its teacher (a dead
   student fails the phase, but for the 3×256 L = 8 row, whose seed-7
   student dies in the reference's step too on the port's points:
   tests/test_torch_distill.py), and that row distilled from seeds 0-3;
8. scene: the hermetic 16-view 160×160 training scene (numpy, host);
9. step: one training step from the committed weights through the kernels
   and through the plain versions: loss and every gradient compared;
10. eval: the trainer's evaluation of the held-out view from the committed
    weights, through K3 + K5 and through the plain versions, against the
    val PSNR the reference measured for those weights;
11. train: `train()` at full width for a few tens of steps, through an
    occupancy refresh, culled steps, dense steps, an eval and a checkpoint;
12. train-small: `train()` of a width-32, depth-3, L = 4 net with
    `kernels.use_pallas=true`: K3 and K4 on the padded net;
    bench-train: `bench.bench_train` for blender_lego at the reference's
    recipe (8 views of 64×64, 10 warm-up and 50 timed steps), its step ms
    and training rays/s beside the step's;
13. probe: TFLOP/s of each P1 variant and each P2 shape, and as yardsticks
    one torch.matmul at the field layer's shape and P1's chain as ten
    torch.matmul calls;
14. cli: `python -m fashion_nerf_torch` (`cli.main`) at full width from a
    checkpoint of the committed weights: `eval` through the kernels and
    with `kernels.use_pallas=false`, `render` over the scene's poses (the
    PNGs read back), two `train --resume` steps at a vanishing learning
    rate and `eval` again, which distils a proposal for the moved weights,
    `bench`, and `parity` on a root without scenes;
15. dist: two ranks over gloo on the one card, started by `python -m
    torch.distributed.run --nproc_per_node 2 chip_smoke.py --dist-worker`:
    `train --set dist.dp=2` (24 steps, `cli.main` on the group) on the
    hermetic scene written in the blender layout, its loss curve beside
    `train()` in one process; 3 steps under dp=2 and under dp=1×tp=2
    against one process's (step-1 loss, every step-1 gradient, the
    parameters after 3 steps; the tp shards' shapes), `segmented_ray_scan`
    at 2 segments on the flagship's fine samples against `volume_render`,
    `render_image` over dp=2 against one process, each rank's K3/K4/K5
    launches; the dp=2 checkpoint restored in one process and `cli eval`
    of it; `train()` with `data.stream=true` (its batches against
    `host_batch_iter`'s, the step with the prefetch against the device
    gather, the device's busy share in a profiler window); the ranks see
    one card (CUDA_VISIBLE_DEVICES) on any machine;
    multicard: one rank a card over NCCL (`dist.mesh.card_plan`). On any
    machine a group of one rank on the card: 3 steps under
    make_mesh(1, 1) bitwise the steps without a mesh, and the collectives
    giving back what they were given. On N ≥ 2 cards also n ranks (the
    largest power of two up to N and 4), each on its own card:
    `train --set dist.dp=n` through `cli.main` (the mesh lines: nccl,
    cuda:N, no staging), training rays/s of n ranks against one process
    (at the preset's batch and at n times it), 3 steps under dp=n and
    dp=n/2×tp=2 against one process ([dist]'s bounds), `render_image`
    over dp=n, the checkpoint's `cli eval`, and K1–K6 and P1 at one
    [kernels] shape each on the last card from a process whose current
    device is cuda:0; on one card it prints that the cross-card run was
    not possible;
16. llff: `llff_fern` at full width through `cli.main` on the hermetic
    forward scene: `train` (K3 + K4 + K5; the loss falls), `eval`
    through the two-stage kernels and with `kernels.use_pallas=false`,
    `render` of an LLFF fixture's spiral (the loader), `bench` at
    800×800 from random init (160 K3 launches a frame) with one live
    chunk held against plain, a 378×504 frame (scanline order) against
    plain, and `parity` over a root of two fixture scenes;
17. tryon: the garment-conditioned try-on serving path at `viton_tryon`'s
    full width: `preprocess` on the procedural pair with the committed
    matcher (its cond stack against the same function on the CPU), the
    matcher's held-out IoUs on the card, a conditioned state built from
    the committed flagship nets (TRYON_CC cond rows of N(0, 0.01²) at the
    reference's row offsets, a seeded encoder; no JAX) and saved through
    `ckpt`, the 800×800 conditioned frame through K1 + K2 and K1 + K6 and
    the plain versions after a cond-aware sweep through K3 and a
    conditioned-teacher distillation, two garments' frames, `eval` and
    `render` of the checkpoint, `render` of a `dynamic_tryon` checkpoint
    over 4 poses (latents 0-3);
18. tryon-train: conditioned training at the try-on presets' full width:
    `train --config viton_tryon --resume` (cli.main) from a checkpoint of
    the [tryon] fixture on the hermetic viton scene through a cond-aware
    occupancy refresh, culled and dense steps, an eval and a checkpoint;
    the same from init, its checkpoint evaluated blockwise through the
    kernels and through their plain versions and densely through K3 and
    plain; one conditioned step through the kernels
    (K3 with its cond window, K4 with its dcond output) against the plain
    step, every gradient of coarse, fine, encoder and latents compared, and
    the steps' rays/s; `eval` of the trained checkpoint through the kernels
    and the plain dense renderer; a few `dynamic_tryon` steps (the trained
    frames' latents move); and `train_matcher` at the reference's unit-test
    recipe, its held-out IoU against the keypoint-grid baseline;
19. m360: mip-NeRF 360 (`mipnerf360`, seeded nets at the published
    widths): K7 at the cell `m360.render.orbit`'s shapes (the 8×1024 NeRF
    MLP on 2,097,152 rows, a 65,536-ray chunk × 32; the 4×256 proposal on
    4,194,304 rows, × 64) against its plain version, with kernel ms (CUDA
    events, median of 5), bound ms, share, plain ms and `library_ms`: a
    `torch.matmul` chain at the trunk's shapes in bf16 (the yardstick; the
    port never calls it); then the cell's 1237×822 frame in 65,536-ray
    chunks through `render_image_blockwise`, K7's launches counted over it
    alone, against perfbench/reference/mipnerf360.py within the cell's
    limits (perfbench/checks/m360.render.orbit.json).
    `python3 chip_smoke.py --only m360` runs the device, build and m360
    phases alone.

In [kernels], K1, K2 and K6 also run at SBs outside 16–64 on the
flagship's nets at K1's chunk (8192 rays): K1 one block of 8, 128, 256
and 512 samples, K2 and K6 256 samples a ray in 32, 2 and 1 blocks (SB 8,
128, 256), and the conditioned K2 at its halved tile at SB 256, each
against its plain version with the tolerances and the executed-tile
checks of the rows at SB 16–64.

In [kernels], K3, K2 and K6 also run a conditioned net: K3 and K6 through
their cond window (a per-ray condpart), K2 with the cond folded into its
x-intercepts, the marches at the conditioned (halved) tile; and K4 runs
its conditioned plan (the recompute's cond window and the dcond output,
d_condpart summed per ray) at the try-on step's fine shape, at the sparsity
prior's one sample a ray, and on a zero-padded conditioned net.

The launch counters are reset just before each path (phases 4, 6, each
frame set of 7's branches, 11, 12 and 13, each subcommand of 14 and 16,
each path of 15 and of multicard (on each rank), 17 and 18) and read
right after it, so they count that path only; a conditioned net's
launches of K2, K3, K4 and K6 count under "slim_march_cond",
"field_cond", "field_bwd_cond" and "carry_march_cond", K3's launches with
the tile-skip flag under "field_alive", K2's on a net without a view
branch under "slim_march_novd", K2's serving the σ march of a proposal
K1 is not built for under "sigma_march_k2", and every launch of K1, K2
and K6 at an SB outside 16–64 under "sigma_march_sb", "slim_march_sb" and
"carry_march_sb".
Any failure raises (non-zero exit). Imports nothing of JAX. The last line
is the device JSON object.

`python3 chip_smoke.py --only multicard` runs the device, build, scene
and multicard phases alone (on a machine with several cards).
`python3 chip_smoke.py --only m360` runs the device, build and m360
phases alone.
`python3 chip_smoke.py --phase-times ROOT` runs ROOT/chip_smoke.py (e.g.
another commit's `git archive` unpacked under build/) with its output
passed through, then prints the seconds it spent a phase tag; run it on
two trees in one call to compare their phases on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

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
# K3 on the trained net at the training step's 786,432 rows, against the f64
# truth (`field_rows_f64`): its largest and 99.9th-percentile rgb and σ
# errors each within this factor of the plain version's against the same
# truth. Measured here (NVIDIA H100 80GB HBM3, 700 W), kernel over plain at
# 786,432 rows and on the 65,536-row chunk: 1.00 and 1.00 on the largest rgb
# error, 1.50 and 1.56 on its 99.9th percentile, 1.06 and 1.00 on σ's
# largest, 1.25 and 1.26 on its 99.9th percentile (the tensor cores' f32
# sums flip twice the plain f32 sums' share of rows); 2 holds the worst
# with a margin of 1.28
K3_ORACLE_FACTOR = 2.0
K1_ATOL = 2e-3                # weights and acc
K2_ATOL = 5e-2                # rgb and weights on the trained fine net
FRAME_PSNR_MIN = 40.0
K4_REL_RMS = 1e-2             # per output tensor, relative RMS
K5_ATOL = 1e-4                # rgb, acc, weights; depth 1e-4·far
STEP_LOSS_REL = 1e-3          # kernel step loss against the plain step's
STEP_GRAD_REL = 1e-2          # every parameter gradient, relative RMS
STEP_GRAD_SAMPLES_REL = 5e-2  # the same, each step with its own fine samples
EVAL_PSNR = 37.27111816       # the asset's val_psnr (the reference's eval)
EVAL_PSNR_TOL = 0.2
K6_ATOL = 5e-2                # rgb, w and acc on the trained fine net
                              # (tests/kernels/test_slimmarch.py:131,157);
                              # depth K6_ATOL·far
PROBE_REL_RMS = 1e-2          # P1/P2 against plain: bf16 1-ulp flips of an
PROBE_MAX_REL = 2e-2          # activation carry on; every element within
                              # PROBE_MAX_REL·max|plain|
# the reference's per-pose gate deltas in dB, POSES order (VERDICT.md:18-21,
# scripts/quality_check.py --gate on the TPU); quality, so they carry over
REF_GATE_DELTAS = (-0.059, -0.041, -0.098, +0.033, -0.018, +0.002, -0.072)
GATE_BAND = 0.05              # each pose's delta within this of the
                              # reference's (its run-to-run noise is ±0.002)
CLI_PSNR_TOL = 0.2            # eval through the kernels against plain, dB
DISTILL_STEPS = 2000          # the preset's proposal.distill_steps
REPS = 5                      # timed calls per kernel (median)
# [tryon]: the conditioned fixture and the try-on checks
TRYON_CC = 64                 # viton_tryon's model.condition_dim
TRYON_COND_STD = 0.01         # the fixture's cond rows: N(0, 0.01²), small
                              # enough to keep the flagship's geometry
MATCHER_IOU = (0.9293, 0.6395)  # assets/matcher_synthetic.npz __meta__:
MATCHER_IOU_TOL = 0.005         # iou_learned, iou_baseline (seeds 2e6 + 0..15)
PREPROCESS_ATOL = 1e-4        # the card's cond stack against the CPU's
TRYON_DISTILL_STEPS = 500     # proposal.distill_steps in [tryon] (the preset's
                              # 2000 take ~16 s a subcommand; 500 keep the
                              # phase short)
# [tryon-train]: steps of `train --config viton_tryon` (depth of run cut;
# widths, batch and samples are the preset's) and of dynamic_tryon; the
# matcher's recipe and bar (tests/unit/test_matcher.py:37-46)
TRYON_TRAIN_STEPS, DYNAMIC_TRAIN_STEPS = 24, 6
MATCHER_RECIPE = dict(steps=60, batch=6, H=48, W=48)
MATCHER_HELD_OUT = range(3_000_001, 3_000_011)
MATCHER_MARGIN = 0.05         # learned IoU > baseline + this
LLFF_STEPS = 24               # [llff]: steps of `train --config llff_fern`
                              # (depth of run cut; the preset runs 200,000)
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet, dense): bf16
# tensor cores, float32 outside them, device memory
PEAK_BF16, PEAK_F32, HBM_BPS = 989e12, 67e12, 3.35e12
FRAME = 800                   # frame height and width of the bench
# K8's LAUNCHES entries, and its f32 instructions a (ray, occupied box)
# pair: the slab test's 6 subtractions and 6 multiplications, 6 per-axis
# min/max, 4 reductions over the axes, 4 for the clamp, 1 compare, 2 for
# the union (csrc/boxcull.cu)
K8_ENTRIES = ("box_cull", "block_hit")
K8_INSTR = 29
SB_K1 = (8, 128, 256, 512)    # [kernels]: K1's SBs outside 16–64
SB_K26 = (8, 128, 256)        # K2's and K6's, 256 samples a ray
SB_FRAMES = (                 # [frame-sb]: overrides, and the "_sb" count
    (("kernels.block_samples=128",), "slim_march_sb"),
    (("kernels.block_samples=8",), "slim_march_sb"),
    (("proposal.block_samples=128", "proposal.eval_n=128"),
     "sigma_march_sb"),
    (("kernels.carry_hoist=false", "kernels.block_samples=128"),
     "carry_march_sb"))
# [sweep]: the row whose seed-7 student dies in both packages' steps, and
# the seeds it is distilled from besides 7
SWEEP_SHARED_DEATH = "proposal p64+f64+cov16 w256d3"
SWEEP_SEEDS = (0, 1, 2, 3)
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke_run")
# [dist]: two ranks on the one card; the checks' tolerances. The step-1
# loss: each rank's rows go through K3 as in one process, only the sum's
# order differs; gradients: K4's row sums split in two and all_reduced;
# after 3 Adam steps the reference's rule (tests/distributed/test_dp.py:
# 55-73); the segmented scan the reference's (test_segmented.py)
DIST_RANKS, DIST_STEPS, DIST_CHECK_STEPS = 2, 24, 3
DIST_LOSS_REL, DIST_GRAD_REL = 1e-5, 1e-4
DIST_PARAM_GAP, DIST_PARAM_SHARE = 1e-4, 0.01
SEG_RAYS, SEG_ATOL, SEG_DEPTH_ATOL = 8192, 3e-4, 3e-3
DIST_FRAME = 200              # render_image over dp=2: a 200×200 frame
DIST_JOIN_S = 300             # a group of ranks that takes longer is killed
# [multicard]: one rank a card over NCCL; at most this many ranks (the
# cards of a 4-card cell), steps held against one process, the weak-scaling
# run's steps (n ranks at n times the batch); NCCL's warnings on stderr
MC_MAX_RANKS, MC_CHECK_STEPS, MC_WEAK_STEPS = 4, 3, 12
MC_ENV = {"NCCL_DEBUG": "WARN"}

SOURCES = {
    "field": ("src/fashion_nerf_torch/kernels/csrc/field.cu",
              "src/fashion_nerf/kernels/posenc_mlp_pallas.py:279"),
    "sigma_march": ("src/fashion_nerf_torch/kernels/csrc/sigmamarch.cu",
                    "src/fashion_nerf/kernels/sigmamarch_pallas.py:91"),
    "slim_march": ("src/fashion_nerf_torch/kernels/csrc/slimmarch.cu",
                   "src/fashion_nerf/kernels/slimmarch_pallas.py:113"),
    "field_bwd": ("src/fashion_nerf_torch/kernels/csrc/field_bwd.cu",
                  "src/fashion_nerf/kernels/posenc_mlp_pallas.py:635"),
    "volrend": ("src/fashion_nerf_torch/kernels/csrc/volrend.cu",
                "src/fashion_nerf/kernels/render_pallas.py:37"),
    "carry_march": ("src/fashion_nerf_torch/kernels/csrc/carrymarch.cu",
                    "src/fashion_nerf/kernels/blockmarch_pallas.py:53"),
    "probe_p1": ("src/fashion_nerf_torch/kernels/csrc/tcprobe.cu",
                 "scripts/mfu_probe.py:30"),
    "probe_p2": ("src/fashion_nerf_torch/kernels/csrc/tcprobe.cu",
                 "scripts/mfu_probe.py:131"),
    # K3 with the tile-skip flag (the two-stage march), K2 on a net without
    # a view branch (the generic proposal march)
    "field_alive": ("src/fashion_nerf_torch/kernels/csrc/field.cu",
                    "src/fashion_nerf/kernels/posenc_mlp_pallas.py:279"),
    "slim_march_novd": ("src/fashion_nerf_torch/kernels/csrc/slimmarch.cu",
                        "src/fashion_nerf/kernels/slimmarch_pallas.py:113"),
    # K2 without a view branch serving the σ march of a proposal that K1
    # (width 128) is not built for
    "sigma_march_k2": ("src/fashion_nerf_torch/kernels/csrc/slimmarch.cu",
                       "src/fashion_nerf/kernels/sigmamarch_pallas.py:91"),
    # the conditioned instantiations: K3's and K6's cond window, K2 at the
    # conditioned tile with the cond in its hoisted intercepts
    "field_cond": ("src/fashion_nerf_torch/kernels/csrc/field.cu",
                   "src/fashion_nerf/kernels/posenc_mlp_pallas.py:279"),
    "slim_march_cond": ("src/fashion_nerf_torch/kernels/csrc/slimmarch.cu",
                        "src/fashion_nerf/kernels/slimmarch_pallas.py:113"),
    "carry_march_cond": ("src/fashion_nerf_torch/kernels/csrc/carrymarch.cu",
                         "src/fashion_nerf/kernels/blockmarch_pallas.py:53"),
    # K4's conditioned plan: the recompute's cond window and the dcond output
    "field_bwd_cond": ("src/fashion_nerf_torch/kernels/csrc/field_bwd.cu",
                       "src/fashion_nerf/kernels/posenc_mlp_pallas.py:635"),
    # K1, K2 and K6 at an SB outside 16–64
    "sigma_march_sb": ("src/fashion_nerf_torch/kernels/csrc/sigmamarch.cu",
                       "src/fashion_nerf/kernels/sigmamarch_pallas.py:91"),
    "slim_march_sb": ("src/fashion_nerf_torch/kernels/csrc/slimmarch.cu",
                      "src/fashion_nerf/kernels/slimmarch_pallas.py:113"),
    "carry_march_sb": ("src/fashion_nerf_torch/kernels/csrc/carrymarch.cu",
                       "src/fashion_nerf/kernels/blockmarch_pallas.py:53"),
    "wide_field": ("src/fashion_nerf_torch/kernels/csrc/widefield.cu",
                   "none (the JAX package has no mip-NeRF 360)"),
    "wide_field_bwd": ("src/fashion_nerf_torch/kernels/csrc/widefield.cu",
                       "none (the JAX package has no mip-NeRF 360)"),
    # K8's two entries: a chunk's culling and a march's block flags
    "box_cull": ("src/fashion_nerf_torch/kernels/csrc/boxcull.cu",
                 "none (the reference culls in XLA glue: "
                 "src/fashion_nerf/core/occupancy.py::ray_multi_aabb)"),
    "block_hit": ("src/fashion_nerf_torch/kernels/csrc/boxcull.cu",
                  "none (the reference culls in XLA glue: "
                  "src/fashion_nerf/render/blockwise.py::_block_hit_flags)"),
}


def routed(plain: bool):
    """The route of a run: every wrapper's plain version on the card
    (`kernels.plain_versions`) when plain, else the kernels."""
    from fashion_nerf_torch import kernels as K
    return K.plain_versions() if plain else contextlib.nullcontext()


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


def device_ms(fn, kernel: str, reps: int = 10) -> dict:
    """Device milliseconds of the kernel named `kernel` in a call of fn(),
    from torch.profiler's device events (mean of `reps` calls): "warm",
    called back to back on the same inputs, and "cold", each call after
    256 MB were written to push the inputs out of the 50 MB L2. A short
    kernel's own time: events around a call of its Python wrapper also
    time the wrapper's checks, allocations and ctypes call."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    out = {}
    for label in ("warm", "cold"):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if label == "cold":
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key]
        if len(hits) != 1 or hits[0].count != reps:
            raise RuntimeError(f"profiler found {[(e.key, e.count) for e in hits]}"
                               f" for {kernel!r}, expected {reps} launches")
        out[label] = hits[0].device_time_total / reps / 1e3
    if not all(v > 0 for v in out.values()):
        raise RuntimeError(f"profiler gave no device time for {kernel!r}")
    return out


def maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_rms(a, b) -> float:
    """‖a − b‖ / ‖b‖ in f64."""
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


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
        if "C7519" in line:     # ptxas's own wgmma register fences
            continue
        if any(w in line for w in ("Function properties", "registers",
                                   "spill", "error")):
            say("build", "ptxas: " + line.strip())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes, peak=PEAK_BF16) -> dict:
    """The least time the card could take for this work: the larger of the
    operations over the peak rate and the bytes (each input read once, each
    output written once) over the memory rate. library_ms is None: no
    single PyTorch call computes any of the port's kernels' functions."""
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / HBM_BPS * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return dict(bound_ms=max(t_ops, t_bytes), bound_by=by, library_ms=None)


def mlp_macs(net) -> int:
    """Multiply-adds a row of the packed net costs (posenc operand padded
    to k0, as the kernels compute it)."""
    lay, W = net.lay, net.width
    macs = sum((W if lay["w_h"][i] is not None else 0) * W
               + (net.k0 if lay["w_a0"][i] is not None else 0) * W
               for i in range(net.depth))
    if net.has_vd:
        return macs + W + W * W + W * (W // 2) + (W // 2) * 3
    return macs + W * 4


def bound_line(b: dict, ms: float) -> str:
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"{b['bound_ms'] / ms:.1%} of it reached")


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


def march_chunk(cfg, params, fine, occ, device) -> SimpleNamespace:
    """The marches' inputs at the main path's chunk (`chunk_inputs`): K1's
    proposal march of 8192 rays × 64 samples (args1) and its plain
    weights, from which the fine march's 96 samples in NB blocks of SB
    (args2: K2's; K6 takes the same rays, flags and samples)."""
    from fashion_nerf_torch.core.sampling import stratified_sample
    from fashion_nerf_torch.kernels import posenc_mlp, sigmamarch, slimmarch
    from fashion_nerf_torch.render.blockwise import (_block_hit_flags,
                                                     _budgets, _pass_dists,
                                                     culling, fine_samples)
    c, o, d = chunk_inputs(cfg, occ, device)
    R = o.shape[0]
    n_prop, p_sb, n_fine = _budgets(cfg, occ)
    near, far, alive0, seg, t_end = culling(cfg, o, d, occ)
    dnorm = torch.linalg.norm(d, dim=-1, keepdim=True)
    t_c = stratified_sample(near, far, R, n_prop, device=device)
    t_pad, d_pad = _pass_dists(t_c, dnorm, t_end, p_sb)
    alive = (alive0.float() * _block_hit_flags(t_pad, p_sb, seg)[:, 0]
             ).contiguous()
    prop = sigmamarch.pack_sigma(params["proposal"])
    hz = sigmamarch.hoist_rays(prop, o, d)
    args1 = (prop, hz, alive, t_pad.contiguous(), d_pad.contiguous())
    w_p, acc_p, _ = sigmamarch.sigma_march_plain(*args1)
    SB = cfg.kernels.block_samples
    t_all = fine_samples(cfg, t_c, w_p, n_fine)
    alive_f = alive0 & (acc_p > cfg.proposal.cull_acc)
    tf_pad, df_pad = _pass_dists(t_all, dnorm, t_end, SB)
    NB = tf_pad.shape[1] // SB
    bhit = _block_hit_flags(tf_pad, SB, seg).contiguous()
    fnet = slimmarch.split_hoist(fine)
    hf = slimmarch.hoist_rays(fnet, o, d)
    dp = posenc_mlp.hoist_dirs(fnet, d).contiguous()
    args2 = (fnet, hf, dp, alive_f.float().contiguous(), bhit,
             tf_pad.contiguous(), df_pad.contiguous(),
             math.log(cfg.kernels.early_term_eps))
    return SimpleNamespace(c=c, o=o, d=d, R=R, p_sb=p_sb, SB=SB, NB=NB,
                           args1=args1, w_p=w_p, acc_p=acc_p, args2=args2,
                           alive_f=alive_f)


def phase_kernels(cfg, device):
    """Each kernel against its plain version at main-path shapes."""
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.core.occupancy import build_from_config
    from fashion_nerf_torch.kernels import posenc_mlp, sigmamarch, slimmarch
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.models.proposal import attach_proposal
    from fashion_nerf_torch.render.blockwise import march_liveness
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
    b3 = bound(2 * pts.shape[0] * mlp_macs(net),
               nbytes(pts, dirpart, net.w, net.b, rgb_k, sig_k))
    say("kernels", f"K3 field 65536 rows: rgb err max {e_rgb:.3g} (tol "
        f"{K3_RGB_MAX}), rows over {K3_RGB_ATOL} {share:.5f} (tol "
        f"{K3_ROW_SHARE}), σ rel err {e_sig:.3g} (tol {K3_SIGMA_REL}); "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b3, ms)}")
    if not ok:
        raise AssertionError("K3 disagrees with its plain version")
    results["field"] = dict(max_abs_err=e_rgb, ms=ms, plain_ms=pms, **b3)
    del rgb_k, sig_k, rgb_p, sig_p

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
    kernel_k3_step(rnet, net, device, pts, dirs)
    results["field_alive"] = kernel_field_alive(rnet, device)
    kernel_small_nets(device)

    # reference occupancy through the plain field, for realistic chunk
    # inputs (and to check the K3 sweep of phase 4 against)
    field = posenc_mlp.make_fused_field()
    with torch.no_grad(), routed(True):
        occ_ref = build_from_config(
            cfg, lambda p, v: field(fine, p, v), device=device)
    results.update(kernel_k8(cfg, occ_ref, device))
    ch = march_chunk(cfg, params, fine, occ_ref, device)
    c, o, d, R, p_sb = ch.c, ch.o, ch.d, ch.R, ch.p_sb

    # K1: the chunk's proposal march, 8192 rays × 64 samples
    args1 = ch.args1
    prop, hz, alive, t_pad, d_pad = args1
    w_k, acc_k, _ = sigmamarch.sigma_march(*args1)
    w_p, acc_p = ch.w_p, ch.acc_p
    torch.cuda.synchronize()
    e1 = max(maxerr(w_k, w_p), maxerr(acc_k, acc_p))
    rpt1 = 2048 // p_sb
    live1 = (alive.view(-1, rpt1) > 0).any(dim=1)
    tiles_k = (w_k.view(-1, rpt1 * p_sb) != 0).any(dim=1)
    tiles_p = (w_p.view(-1, rpt1 * p_sb) != 0).any(dim=1)
    same1 = bool(torch.equal(tiles_k, tiles_p))
    n_live1 = int(live1.sum())
    call_ms = cuda_ms(lambda: sigmamarch.sigma_march(*args1))
    dev1 = device_ms(lambda: sigmamarch.sigma_march(*args1),
                     "sigma_march_kernel")
    ms = dev1["cold"]
    pms = cuda_ms(lambda: sigmamarch.sigma_march_plain(*args1))
    b1 = bound(2 * n_live1 * 2048 * mlp_macs(prop),
               nbytes(alive, *hz, t_pad, d_pad, prop.w, prop.b, w_k, acc_k,
                      acc_k))
    say("kernels", f"K1 sigma march chunk {c} ({R} rays × {p_sb}): "
        f"w/acc err {e1:.3g} (tol {K1_ATOL}); live tiles {n_live1}/"
        f"{R // rpt1} (marched whole); tiles with a nonzero weight "
        f"{int(tiles_k.sum())}, identical to plain: {same1}; kernel on the device {ms:.4f} ms "
        f"(inputs warm {dev1['warm']:.4f}), a call of the wrapper "
        f"{call_ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b1, ms)}")
    if not (e1 <= K1_ATOL and n_live1 < live1.numel() and same1):
        raise AssertionError("K1 disagrees with its plain version")
    results["sigma_march"] = dict(max_abs_err=e1, ms=ms, wrapper_ms=call_ms,
                                  plain_ms=pms, **b1)

    # K2: the chunk's fine march, 8192 rays × 96 samples, NB = 3
    SB, NB, args2 = ch.SB, ch.NB, ch.args2
    fnet, hf, dp, _, bhit, tf_pad, df_pad, log_eps = args2
    alive_f = ch.alive_f
    rgb_k, wf_k, lt_k = slimmarch.slim_march(*args2)
    rgb_p, wf_p, lt_p = slimmarch.slim_march_plain(*args2)
    torch.cuda.synchronize()
    e2 = max(maxerr(rgb_k, rgb_p), maxerr(wf_k, wf_p))
    rpt2 = 2048 // SB
    cand = (alive_f.float()[:, None] * bhit).view(-1, rpt2, NB)
    dead2 = int((cand.amax(dim=1) == 0).sum())
    term = int((lt_p < log_eps).sum())
    hit_f = alive_f.float()
    ex_k = march_liveness(wf_k, hit_f, bhit, cfg)["tile_alive"]
    ex_p = march_liveness(wf_p, hit_f, bhit, cfg)["tile_alive"]
    same2 = bool(torch.equal(ex_k, ex_p))
    n_ex = int(ex_p.sum())
    ms = cuda_ms(lambda: slimmarch.slim_march(*args2))
    pms = cuda_ms(lambda: slimmarch.slim_march_plain(*args2))
    b2 = bound(2 * n_ex * 2048 * mlp_macs(fnet),
               nbytes(hit_f, bhit, *hf, dp, tf_pad, df_pad, fnet.w, fnet.b,
                      rgb_k, wf_k, lt_k))
    say("kernels", f"K2 fine march chunk {c} ({R} rays × {NB}×{SB}): "
        f"rgb/w err {e2:.3g} (tol {K2_ATOL}); executed (tile, block) "
        f"{int(ex_k.sum())}/{ex_k.numel()}, identical to plain: {same2}; "
        f"dead (tile, block) ≥ {dead2}; terminated rays {term}; kernel "
        f"{ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b2, ms)}")
    if not (e2 <= K2_ATOL and dead2 > 0 and term > 0 and same2
            and bool(torch.isfinite(rgb_k).all())):
        raise AssertionError("K2 disagrees with its plain version")
    results["slim_march"] = dict(max_abs_err=e2, ms=ms, plain_ms=pms, **b2)
    results["slim_march_novd"] = kernel_k2_novd(cfg, params["proposal"], o,
                                                d, args1, w_k)
    results["carry_march"] = kernel_k6(cfg, fine, dp, o, d, alive_f, bhit,
                                       tf_pad, df_pad, (rgb_k, wf_k))
    results.update(kernel_cond(cfg, trained, pts, dirs,
                               (o, d, alive_f, bhit, tf_pad, df_pad),
                               results, device))
    results["field_bwd"] = kernel_k4(net, rng, device)
    results["field_bwd_cond"] = kernel_k4_cond(trained, results, device)
    results["sigma_march_k2"] = kernel_skips(
        cfg, pts, dirs, (o, d, alive_f, bhit, tf_pad, df_pad), args1, device)
    results["volrend"] = kernel_k5(cfg, rng, device)
    results.update(kernel_probe(device))
    results.update(kernel_sb(cfg, fine, params["proposal"], trained, o, d,
                             occ_ref, device))
    return results, occ_ref


def kernel_k8(cfg, occ, device) -> dict:
    """K8 at the orbit cell's chunk: the 65,536 rays of an 800×800 orbit
    frame (perfbench/traffic/orbit40_800.json, its first pose, tile order)
    with the most rays in the global box, against the flagship's 512 macro
    boxes (the occupied ones, `occupied_boxes`): box_cull, then block_hit
    at NB 1 (the proposal's 64 samples) and NB 3 (96 samples in blocks of
    32), each equal to its plain version (the torch composition on the
    occupied boxes, timed as library_ms) and to the composition over all
    512 boxes with their flags (what the render ran before K8, timed as
    all_boxes_ms), with the kernel's device time (torch.profiler) beside a
    call of its wrapper, its bound (the bytes of rays and samples in and
    results out at 3.35 TB/s) and the f32 issue floor (K8_INSTR
    instructions a (ray, occupied box) pair at half the 67 TFLOP/s FMA
    rate)."""
    from fashion_nerf_torch.core.cameras import generate_rays
    from fashion_nerf_torch.core.occupancy import (block_overlap,
                                                   box_segments,
                                                   occupied_boxes,
                                                   ray_aabb_intersect,
                                                   ray_multi_aabb)
    from fashion_nerf_torch.core.sampling import stratified_sample
    from fashion_nerf_torch.kernels import boxcull
    from fashion_nerf_torch.render.blockwise import _pass_dists, _to_tiles
    sys.path.insert(0, ROOT)
    from perfbench.drivers.render import make_poses
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "orbit40_800.json")) as f:
        traffic = json.load(f)
    H, W = traffic["frame"]
    chunk = traffic["overrides"]["render.chunk"]
    focal = 0.5 * W / math.tan(0.5 * traffic["fov_x"])
    o, d = generate_rays(H, W, focal, make_poses(traffic["poses"])[0],
                         device=device)
    o, d = (_to_tiles(x.reshape(-1, 3), H, W) for x in (o, d))
    near, far = cfg.render.near, cfg.render.far
    n_box = [int(ray_aabb_intersect(o[c:c + chunk], d[c:c + chunk],
                                    occ.box_min, occ.box_max, near,
                                    far)[2].sum())
             for c in range(0, H * W - chunk + 1, chunk)]
    c = chunk * int(np.argmax(n_box))
    o, d = o[c:c + chunk].contiguous(), d[c:c + chunk]
    R = chunk
    n_boxes, n_occ = occ.boxes_occ.numel(), int(occ.boxes_occ.sum())
    issue_ms = R * n_occ * K8_INSTR / (PEAK_F32 / 2) * 1e3
    out = {}
    seg = box_segments(o, d, *occupied_boxes(occ), near, far)
    got = boxcull.box_cull(seg)
    want = boxcull.box_cull_plain(seg)
    full = ray_multi_aabb(o, d, occ, near, far)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, want, full))
    n_hit = int(got[2].sum())
    rows = [("box_cull", "box_cull_kernel", lambda: boxcull.box_cull(seg),
             lambda: boxcull.box_cull_plain(seg),
             lambda: ray_multi_aabb(o, d, occ, near, far)[:3], same,
             nbytes(o, d, *got), f"{R} rays")]
    for NB, SB, S in ((1, 64, 64), (3, 32, 96)):
        t = stratified_sample(got[0], got[1], R, S)
        t_pad, _ = _pass_dists(t, torch.ones((R, 1), device=device), far, SB)
        t_pad = t_pad.contiguous()
        f_k = boxcull.block_hit(t_pad, SB, seg)
        f_p = boxcull.block_hit_plain(t_pad, SB, seg)
        f_a = block_overlap(t_pad, SB, full[3:], R, NB)
        torch.cuda.synchronize()

        def kern(t_pad=t_pad, SB=SB):
            return boxcull.block_hit(t_pad, SB, seg)

        def plain(t_pad=t_pad, SB=SB):
            return boxcull.block_hit_plain(t_pad, SB, seg)

        def all_boxes(t_pad=t_pad, SB=SB, NB=NB):
            return block_overlap(t_pad, SB, ray_multi_aabb(
                o, d, occ, near, far)[3:], R, NB)
        ok = (torch.equal(f_k, f_p) and torch.equal(f_k, f_a)
              and 0 < f_k.sum() < f_k.numel())
        rows.append((f"block_hit NB {NB}", "block_hit_kernel", kern, plain,
                     all_boxes, ok,
                     nbytes(o, d, t_pad, f_k),
                     f"{R} rays × {NB}×{SB}, {int(f_k.sum())} blocks hit"))
    for label, kname, fn, plain, before, ok, n_b, shape in rows:
        dev_k = device_ms(fn, kname)
        ms = dev_k["cold"]
        call_ms = cuda_ms(fn)
        lib = cuda_ms(plain)
        all_ms = cuda_ms(before)
        b = bound(0, n_b)
        b["library_ms"] = lib
        say("kernels", f"K8 {label} ({shape}; {n_occ} of {n_boxes} boxes "
            f"occupied, {n_hit} rays hit): equal to plain and to all boxes: "
            f"{ok}; kernel on the device {ms:.4f} ms (inputs warm "
            f"{dev_k['warm']:.4f}), a call of the wrapper {call_ms:.3f} ms; "
            f"library_ms (the plain composition, occupied boxes) {lib:.3f}, "
            f"all {n_boxes} boxes with their flags {all_ms:.3f}; "
            f"{bound_line(b, ms)}; f32 issue floor {issue_ms:.4f} ms "
            f"({issue_ms / ms:.1%})")
        if not (ok and 0 < n_hit < R):
            raise AssertionError(f"K8 {label} disagrees with its plain "
                                 "version")
        out[label] = dict(max_abs_err=0.0, ms=ms, wrapper_ms=call_ms,
                          plain_ms=lib, all_boxes_ms=all_ms,
                          issue_ms=issue_ms, **b)
    return {"box_cull": out["box_cull"],
            "block_hit": {**out["block_hit NB 3"],
                          "nb1": out["block_hit NB 1"]}}


def kernel_sb(cfg, fine, prop_model, trained, o, d, occ, device):
    """K1, K2 and K6 at SBs outside 16–64 on K1's chunk (8192 rays): K1 on
    the committed proposal, one block of SB_K1 stratified samples a ray;
    K2 and K6 on the committed fine net, 256 stratified samples a ray in
    blocks of SB_K26, and K2 on the conditioned flagship (cond_tree) at
    its halved tile at SB 256. Each against its plain version: K1 w/acc
    ≤ K1_ATOL and the same tiles with a nonzero weight; K2 and K6 rgb/w
    (K6 also acc) ≤ K2_ATOL / K6_ATOL and the same executed (tile, block)
    pairs; K6 also against K2. Launches counted under the "_sb" entries
    (two a block where the tiles exceed one launch's). → the SB 128 rows
    as "sigma_march_sb", "slim_march_sb", "carry_march_sb"."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.core.sampling import stratified_sample
    from fashion_nerf_torch.kernels import (carrymarch, posenc_mlp,
                                            sigmamarch, slimmarch)
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.render.blockwise import (_block_hit_flags,
                                                     _pass_dists, culling,
                                                     march_liveness)
    R = o.shape[0]
    near, far, alive0, seg, t_end = culling(cfg, o, d, occ)
    dnorm = torch.linalg.norm(d, dim=-1, keepdim=True)
    log_eps = math.log(cfg.kernels.early_term_eps)
    out = {}

    def launches(name, fn):
        n0 = K.LAUNCHES[name]
        res = fn()
        return res, K.LAUNCHES[name] - n0

    prop = sigmamarch.pack_sigma(prop_model)
    hz = sigmamarch.hoist_rays(prop, o, d)
    for SB in SB_K1:
        t_c = stratified_sample(near, far, R, SB, device=device)
        t_pad, d_pad = _pass_dists(t_c, dnorm, t_end, SB)
        alive = (alive0.float() * _block_hit_flags(t_pad, SB, seg)[:, 0]
                 ).contiguous()
        args = (prop, hz, alive, t_pad.contiguous(), d_pad.contiguous())
        (w_k, acc_k, lt_k), n_l = launches(
            "sigma_march_sb", lambda: sigmamarch.sigma_march(*args))
        w_p, acc_p, _ = sigmamarch.sigma_march_plain(*args)
        torch.cuda.synchronize()
        e = max(maxerr(w_k, w_p), maxerr(acc_k, acc_p))
        rpt = K.TILE_ROWS // SB
        live = (alive.view(-1, rpt) > 0).any(dim=1)
        tiles_k = (w_k.view(-1, rpt * SB) != 0).any(dim=1)
        tiles_p = (w_p.view(-1, rpt * SB) != 0).any(dim=1)
        same = bool(torch.equal(tiles_k, tiles_p))
        n_live = int(live.sum())
        ms = cuda_ms(lambda: sigmamarch.sigma_march(*args))
        pms = cuda_ms(lambda: sigmamarch.sigma_march_plain(*args))
        b = bound(2 * n_live * K.TILE_ROWS * mlp_macs(prop),
                  nbytes(alive, *hz, t_pad, d_pad, prop.w, prop.b, w_k, acc_k,
                         lt_k))
        want = -(-(R // rpt) // K.MARCH_MAX_TILES)
        say("kernels", f"K1 sigma march at SB {SB}, chunk ({R} rays × 1×{SB})"
            f": w/acc err {e:.3g} (tol {K1_ATOL}); live tiles {n_live}/"
            f"{live.numel()}; tiles with a nonzero weight "
            f"{int(tiles_k.sum())}, identical to plain: {same}; launches "
            f"{n_l} (sigma_march_sb); kernel {ms:.3f} ms, plain {pms:.3f} "
            f"ms; {bound_line(b, ms)}")
        if not (e <= K1_ATOL and same and 0 < n_live < live.numel()
                and n_l == want and bool(torch.isfinite(w_k).all())):
            raise AssertionError(f"K1 at SB {SB} disagrees with its plain "
                                 "version")
        if SB == 128:
            out["sigma_march_sb"] = dict(max_abs_err=e, ms=ms, plain_ms=pms,
                                         **b)

    def march_rows(label, fnet, cnet, hf, dp, cpr, tile_rows, SBs, k6=True):
        t_f = stratified_sample(near, far, R, 256, device=device)
        hit = alive0.float().contiguous()
        for SB in SBs:
            tf_pad, df_pad = _pass_dists(t_f, dnorm, t_end, SB)
            NB = tf_pad.shape[1] // SB
            bhit = _block_hit_flags(tf_pad, SB, seg).contiguous()
            args2 = (fnet, hf, dp, hit, bhit, tf_pad.contiguous(),
                     df_pad.contiguous(), log_eps)
            s_k, n2 = launches("slim_march_sb",
                               lambda: slimmarch.slim_march(*args2))
            s_p = slimmarch.slim_march_plain(*args2)
            torch.cuda.synchronize()

            def executed(w):
                return march_liveness(w, hit, bhit, cfg,
                                      tile_rows)["tile_alive"]

            ex_k, ex_p = executed(s_k[1]), executed(s_p[1])
            n_ex = int(ex_p.sum())
            same = bool(torch.equal(ex_k, ex_p))
            e2 = max(maxerr(s_k[0], s_p[0]), maxerr(s_k[1], s_p[1]))
            ms2 = cuda_ms(lambda: slimmarch.slim_march(*args2))
            pms2 = cuda_ms(lambda: slimmarch.slim_march_plain(*args2))
            b2 = bound(2 * n_ex * tile_rows * mlp_macs(fnet),
                       nbytes(hit, bhit, *hf, dp, tf_pad, df_pad, fnet.w,
                              fnet.b, *s_k))
            per_block = -(-(R // (tile_rows // SB)) // K.MARCH_MAX_TILES)
            ok = (e2 <= K2_ATOL and same and 0 < n_ex < ex_p.numel()
                  and n2 == NB * per_block
                  and bool(torch.isfinite(s_k[0]).all()))
            line = (f"K2 rgb/w err {e2:.3g} (tol {K2_ATOL}), launches {n2}, "
                    f"{ms2:.3f} ms, plain {pms2:.3f} ms, "
                    f"{bound_line(b2, ms2)}")
            if SB == 128 and k6:
                out["slim_march_sb"] = dict(max_abs_err=e2, ms=ms2,
                                            plain_ms=pms2, **b2)
            if k6:
                args6 = (cnet, dp, o, d, hit, bhit, tf_pad.contiguous(),
                         df_pad.contiguous(), log_eps)
                c_k, n6 = launches("carry_march_sb",
                                   lambda: carrymarch.carry_march(*args6))
                c_p = carrymarch.carry_march_plain(*args6)
                torch.cuda.synchronize()
                ex6 = executed(c_k[3])
                e6 = max(maxerr(c_k[0], c_p[0]), maxerr(c_k[2], c_p[2]),
                         maxerr(c_k[3], c_p[3]))
                e62 = max(maxerr(c_k[0], s_k[0]), maxerr(c_k[3], s_k[1]))
                ms6 = cuda_ms(lambda: carrymarch.carry_march(*args6))
                pms6 = cuda_ms(lambda: carrymarch.carry_march_plain(*args6))
                b6 = bound(2 * n_ex * tile_rows * mlp_macs(cnet),
                           nbytes(dp, o, d, hit, bhit, tf_pad, df_pad,
                                  cnet.w, cnet.b, *c_k[:4]))
                same = same and bool(torch.equal(ex6, ex_p))
                ok = (ok and e6 <= K6_ATOL and e62 <= K6_ATOL and same
                      and n6 == NB * per_block
                      and bool(torch.isfinite(c_k[0]).all()))
                line += (f"; K6 rgb/acc/w err {e6:.3g} (tol {K6_ATOL}), "
                         f"against K2 {e62:.3g}, launches {n6}, {ms6:.3f} "
                         f"ms, plain {pms6:.3f} ms, {bound_line(b6, ms6)}")
                if SB == 128:
                    out["carry_march_sb"] = dict(max_abs_err=e6, ms=ms6,
                                                 plain_ms=pms6, **b6)
            say("kernels", f"{label} at SB {SB}, chunk ({R} rays × {NB}×{SB}"
                f"): executed (tile, block) {n_ex}/{ex_p.numel()}, identical "
                f"to plain: {same}; {line}")
            if not ok:
                raise AssertionError(f"{label} at SB {SB}: a march disagrees "
                                     "with its plain version")

    fnet = slimmarch.split_hoist(fine)
    march_rows("K2 and K6 fine march", fnet,
               posenc_mlp.pack_params(fine, hoist_x=False),
               slimmarch.hoist_rays(fnet, o, d),
               posenc_mlp.hoist_dirs(fnet, d).contiguous(), None,
               K.TILE_ROWS, SB_K26)
    rng = np.random.default_rng(23)
    cfine = load_flax_params(cond_tree(trained["fine"], TRYON_CC, rng),
                             compute_dtype="bfloat16", device=device,
                             cond_dim=TRYON_CC)
    cfnet = slimmarch.split_hoist(cfine)
    scene_cond = torch.from_numpy(rng.normal(size=(1, TRYON_CC)).astype(
        np.float32)).to(device).expand(R, TRYON_CC)
    cpr = posenc_mlp.hoist_cond(cfnet, scene_cond)
    march_rows("K2 conditioned fine march (tile 1024)", cfnet, None,
               slimmarch.hoist_rays(cfnet, o, d, cpr),
               posenc_mlp.hoist_dirs(cfnet, d).contiguous(), cpr,
               K.TILE_ROWS // 2, (256,), k6=False)
    return out


def field_rows_f64(net, pts, dirpart, spr: int):
    """K3's function in f64, the truth K3 and its plain version are held
    to: the same bf16 weights, the same bf16 posenc operand (phases in f32,
    as both compute them) and view term, every sum in f64, and each
    activation rounded to bf16 where the kernels round it (once, from the
    f64 sum) → (rgb (n, 3), σ (n,)) f64."""
    from fashion_nerf_torch.kernels import posenc_mlp
    a0 = posenc_mlp.field_operand(pts, net.L, net.k0).double()
    net64 = dataclasses.replace(net, wf=net.w.double(), b=net.b.double())
    return posenc_mlp.mlp_rows(
        net64, a0, dir_rows=posenc_mlp.per_row(dirpart, spr).double())


def oracle_errors(out, truth) -> dict:
    """Per-row errors of a K3 output against the f64 truth, rgb's largest
    channel error and σ's |Δσ| / (1 + |σ|): their largest, their 99.9th
    percentile, and the share of rows with rgb off by more than
    K3_RGB_ATOL (a flipped bf16 activation)."""
    e_rgb = (out[0].double() - truth[0]).abs().amax(dim=1)
    e_sig = (out[1].double() - truth[1]).abs() / (1 + truth[1].abs())
    return {"rgb_max": float(e_rgb.max()),
            "rgb_p999": float(torch.quantile(e_rgb, 0.999)),
            "sig_max": float(e_sig.max()),
            "sig_p999": float(torch.quantile(e_sig, 0.999)),
            "rgb_rows_over": float((e_rgb > K3_RGB_ATOL).double().mean())}


def k3_against_oracle(net, pts, dirpart, spr: int) -> tuple:
    """K3 and its plain version against `field_rows_f64` on the same
    inputs → (kernel's `oracle_errors`, plain's, kernel against plain's
    largest rgb error)."""
    from fashion_nerf_torch.kernels import posenc_mlp
    truth = field_rows_f64(net, pts, dirpart, spr)
    out_k = posenc_mlp.field_rows(net, pts, dirpart, spr)
    out_p = posenc_mlp.field_rows_plain(net, pts, dirpart, spr)
    e_kp = maxerr(out_k[0], out_p[0])
    return oracle_errors(out_k, truth), oracle_errors(out_p, truth), e_kp


def oracle_line(ek: dict, ep: dict) -> str:
    return "; ".join(f"{k} kernel {ek[k]:.3g} plain {ep[k]:.3g}"
                     for k in ek)


def kernel_k3_step(net, trained, device, pts65=None, dirs65=None):
    """K3 at the fine field's shape in a training step, the shape its
    launches are counted on: 4096 rays × 192 samples = 786,432 rows. The
    random net of the flagship's shape is held to K3_RGB_ATOL on every
    row against the plain version. The trained net, whose rows a bf16
    flip moves by up to ~0.05, is held against the f64 truth
    (`field_rows_f64`): the kernel's largest and 99.9th-percentile rgb and
    σ errors within K3_ORACLE_FACTOR of the plain version's against the
    same truth. The same errors on the 65,536-row sweep chunk (pts65,
    dirs65) are printed beside them: the two row counts tell whether the
    gap between kernel and plain is set by the row count or by the
    kernel's sums."""
    from fashion_nerf_torch.kernels import posenc_mlp
    rng = np.random.default_rng(11)
    R, S = 4096, 192
    n = R * S
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(R, 3)).astype(
        np.float32)).to(device)
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    out_k = posenc_mlp.field_rows(net, pts, dp, S)
    out_p = posenc_mlp.field_rows_plain(net, pts, dp, S)
    torch.cuda.synchronize()
    e_rgb = maxerr(out_k[0], out_p[0])
    e_sig = float(((out_k[1] - out_p[1]).abs() / (1 + out_p[1].abs())).max())
    ok = (e_rgb <= K3_RGB_ATOL and e_sig <= K3_SIGMA_REL
          and bool(torch.isfinite(out_k[0]).all()))
    ms = cuda_ms(lambda: posenc_mlp.field_rows(net, pts, dp, S))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_plain(net, pts, dp, S))
    b = bound(2 * n * mlp_macs(net), nbytes(pts, dp, net.w, net.b, *out_k))
    del out_k, out_p
    ek, ep, e_kp = k3_against_oracle(
        trained, pts, posenc_mlp.hoist_dirs(trained, dirs).contiguous(), S)
    torch.cuda.empty_cache()
    held = all(ek[k] <= K3_ORACLE_FACTOR * ep[k]
               for k in ("rgb_max", "rgb_p999", "sig_max", "sig_p999"))
    say("kernels", f"K3 field step shape {n} rows ({R} rays × {S}), random "
        f"net: rgb err {e_rgb:.3g} (tol {K3_RGB_ATOL} on every row), σ rel "
        f"err {e_sig:.3g} (tol {K3_SIGMA_REL}); kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms; {bound_line(b, ms)}")
    say("kernels", f"K3 field step shape {n} rows, the trained net against "
        f"its f64 truth (kernel's max and 99.9th percentile each within "
        f"{K3_ORACLE_FACTOR}× the plain version's): {oracle_line(ek, ep)}; "
        f"kernel against plain rgb {e_kp:.3g}; held: {held}")
    if pts65 is not None:
        ek65, ep65, e_kp65 = k3_against_oracle(
            trained, pts65, posenc_mlp.hoist_dirs(trained, dirs65)
            .contiguous(), pts65.shape[0] // dirs65.shape[0])
        say("kernels", f"K3 field {pts65.shape[0]} rows (the sweep chunk), "
            f"the trained net against its f64 truth: "
            f"{oracle_line(ek65, ep65)}; kernel against plain rgb "
            f"{e_kp65:.3g}")
    if not ok:
        raise AssertionError("K3 disagrees with its plain version at the "
                             "step shape")
    if not held:
        raise AssertionError("K3 on the trained net is further from the f64 "
                             "truth than K3_ORACLE_FACTOR × the plain "
                             "version at the step shape")


def kernel_field_alive(net, device):
    """K3 with the tile-skip flag at the two-stage march's block shape:
    32,768 rays × SB 32 = 1,048,576 rows (spr 32, 512 tiles of 2048 rows),
    on the random net of the flagship's shape (the trained net's largest
    bf16 flip grows with the row count, kernel_k3_step). All tiles live,
    then every other tile dead: live rows bitwise equal to K3 without the
    flag, dead rows exactly rgb 0 and σ −1e10, every row within
    K3_RGB_ATOL (σ K3_SIGMA_REL) of the plain version with the same flags.
    Timed both ways; the bound counts the live rows' operations."""
    from fashion_nerf_torch.kernels import posenc_mlp
    rng = np.random.default_rng(21)
    R, SB = 32768, 32
    n = R * SB
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(R, 3)).astype(
        np.float32)).to(device)
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    tiles = n // net.tile_rows
    all_live = torch.ones(tiles, device=device)
    half = (torch.arange(tiles, device=device) % 2 == 0).float()
    live = half.repeat_interleave(net.tile_rows) > 0

    def run(alive=None):
        return posenc_mlp.field_rows(net, pts, dp, SB, alive=alive)

    rgb_f, sig_f = run()
    rgb_a, sig_a = run(all_live)
    rgb_h, sig_h = run(half)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, SB, alive=half)
    torch.cuda.synchronize()
    same_all = bool(torch.equal(rgb_a, rgb_f) and torch.equal(sig_a, sig_f))
    same_live = bool(torch.equal(rgb_h[live], rgb_f[live])
                     and torch.equal(sig_h[live], sig_f[live]))
    sentinels = bool((rgb_h[~live] == 0).all()
                     and (sig_h[~live] == posenc_mlp.DEAD_SIGMA).all())
    e_rgb = maxerr(rgb_h, rgb_p)
    e_sig = float(((sig_h - sig_p).abs() / (1 + sig_p.abs())).max())
    del rgb_f, sig_f, rgb_a, sig_a, rgb_p, sig_p
    ms_all = cuda_ms(lambda: run(all_live))
    ms_half = cuda_ms(lambda: run(half))
    ms_none = cuda_ms(lambda: run())
    pms = cuda_ms(lambda: posenc_mlp.field_rows_plain(net, pts, dp, SB,
                                                      alive=half))
    io = (pts, dp, net.w, net.b, rgb_h, sig_h)
    b_all = bound(2 * n * mlp_macs(net), nbytes(*io, all_live))
    b_half = bound(2 * (n // 2) * mlp_macs(net), nbytes(*io, half))
    torch.cuda.empty_cache()
    say("kernels", f"K3 field with the tile-skip flag, {n} rows ({R} rays × "
        f"{SB}, {tiles} tiles): all live {ms_all:.3f} ms (bitwise the run "
        f"without the flag: {same_all}; {bound_line(b_all, ms_all)}), every "
        f"other tile dead {ms_half:.3f} ms (live rows bitwise: {same_live}, "
        f"dead rows exact sentinels: {sentinels}; "
        f"{bound_line(b_half, ms_half)}), without the flag {ms_none:.3f} "
        f"ms; against plain with the flags: rgb err {e_rgb:.3g} (tol "
        f"{K3_RGB_ATOL} on every row), σ rel err {e_sig:.3g}; plain "
        f"{pms:.3f} ms")
    if not (same_all and same_live and sentinels and e_rgb <= K3_RGB_ATOL
            and e_sig <= K3_SIGMA_REL):
        raise AssertionError("K3 with the tile-skip flag disagrees")
    return dict(max_abs_err=e_rgb, ms=ms_half, plain_ms=pms, **b_half,
                ms_all_live=ms_all, bound_all_live_ms=b_all["bound_ms"],
                ms_no_flag=ms_none)


def kernel_k2_novd(cfg, model, o, d, args1, w1):
    """K2 on a net without a view branch: the σ-only proposal net (2×128,
    L = 6, no skip layer) at K1's chunk, 8192 rays × 64 samples, SB 64,
    NB 1, the generic proposal march's shape. Held against its plain
    version and against K1's weights on the same input (K1_ATOL), with
    the executed (tile, block) pairs identical to plain; the bound is K1's
    (the same operations on the executed tiles)."""
    from fashion_nerf_torch.kernels import slimmarch
    from fashion_nerf_torch.render.blockwise import march_liveness
    _, _, alive, t_pad, d_pad = args1
    net = slimmarch.split_hoist(model)
    R, SB = t_pad.shape
    hz = slimmarch.hoist_rays(net, o, d)
    bhit = torch.ones((R, 1), device=t_pad.device)
    args = (net, hz, None, alive, bhit, t_pad, d_pad,
            math.log(cfg.kernels.early_term_eps))
    rgb_k, w_k, lt_k = slimmarch.slim_march(*args)
    rgb_p, w_p, _ = slimmarch.slim_march_plain(*args)
    torch.cuda.synchronize()
    e = max(maxerr(rgb_k, rgb_p), maxerr(w_k, w_p))
    e1 = maxerr(w_k, w1)
    ex_k = march_liveness(w_k, alive, bhit, cfg)["tile_alive"]
    ex_p = march_liveness(w_p, alive, bhit, cfg)["tile_alive"]
    same = bool(torch.equal(ex_k, ex_p))
    n_ex = int(ex_p.sum())
    ms = cuda_ms(lambda: slimmarch.slim_march(*args))
    pms = cuda_ms(lambda: slimmarch.slim_march_plain(*args))
    b = bound(2 * n_ex * 2048 * mlp_macs(net),
              nbytes(alive, bhit, *hz, t_pad, d_pad, net.w, net.b, rgb_k,
                     w_k, lt_k))
    say("kernels", f"K2 without a view branch, the proposal net ({R} rays "
        f"× {SB}, NB 1): rgb/w err {e:.3g} against plain, w err {e1:.3g} "
        f"against K1 (tol {K1_ATOL}); executed (tile, block) {n_ex}/"
        f"{ex_k.numel()}, identical to plain: {same}; kernel {ms:.3f} ms, "
        f"plain {pms:.3f} ms; {bound_line(b, ms)}")
    if not (e <= K1_ATOL and e1 <= K1_ATOL and same and 0 < n_ex
            < ex_k.numel() and bool(torch.isfinite(rgb_k).all())):
        raise AssertionError("K2 without a view branch disagrees")
    return dict(max_abs_err=max(e, e1), ms=ms, plain_ms=pms, **b)


def kernel_small_nets(device):
    """K3 and K4 on nets below the kernels' widths, which the wrappers run
    zero-padded: width 32, depth 3, L = 4 and width 64, depth 4, L = 6 with
    a skip layer, 65,536 rows (1024 rays × 64), against the plain versions
    on the unpadded nets. K3 on every row (K3_RGB_ATOL, K3_SIGMA_REL), K4
    per tensor (K4_REL_RMS) with its gradients in the unpadded layout."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.kernels import posenc_mlp
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    rng = np.random.default_rng(21)
    n, spr = 65536, 64
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(n // spr, 3)).astype(
        np.float32)).to(device)
    g_rgb = torch.from_numpy((1e-4 * rng.normal(size=(n, 3))).astype(
        np.float32)).to(device)
    g_sig = torch.from_numpy((1e-4 * rng.normal(size=n)).astype(
        np.float32)).to(device)
    for W, depth, L, skip in ((32, 3, 4, None), (64, 4, 6, 2)):
        cx = 3 * (2 * L + 1)
        shapes = {f"trunk_{i}": ((cx + W) if i == skip
                                 else (cx if i == 0 else W), W)
                  for i in range(depth)}
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
        model = load_flax_params(random_tree({"params": {
            k: {"kernel": np.empty(v), "bias": np.empty(v[1])}
            for k, v in shapes.items()}}, rng), compute_dtype="bfloat16",
            device=device)
        net = posenc_mlp.pack_params(model, hoist_x=False)
        dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
        n0 = dict(K.LAUNCHES)
        rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, spr)
        rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, spr)
        args = (net, pts, dp, g_rgb, g_sig, spr)
        out_k = posenc_mlp.field_rows_backward(*args)
        out_p = posenc_mlp.field_rows_backward_plain(*args)
        torch.cuda.synchronize()
        launched = (K.LAUNCHES["field"] - n0["field"],
                    K.LAUNCHES["field_bwd"] - n0["field_bwd"])
        e_rgb = maxerr(rgb_k, rgb_p)
        e_sig = float(((sig_k - sig_p).abs() / (1 + sig_p.abs())).max())
        rel = {k: rel_rms(a, b) for k, a, b in zip(
            ("d_pts", "d_dir", "d_w", "d_b"), out_k, out_p)}
        shapes_ok = all(a.shape == b.shape for a, b in zip(out_k, out_p))
        ms3 = cuda_ms(lambda: posenc_mlp.field_rows(net, pts, dp, spr))
        ms4 = cuda_ms(lambda: posenc_mlp.field_rows_backward(*args))
        big = net.padded
        say("kernels", f"K3/K4 on a {depth}×{W} net, L = {L}, padded to "
            f"{big.depth}×{big.width}, k0 {net.k0} → {big.k0}, {n} rows: K3 "
            f"rgb err {e_rgb:.3g} (tol {K3_RGB_ATOL} on every row), σ rel "
            f"err {e_sig:.3g} (tol {K3_SIGMA_REL}); K4 relative RMS "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})} "
            f"(tol {K4_REL_RMS} each), gradients in the unpadded layout: "
            f"{shapes_ok}; launches K3 {launched[0]}, K4 {launched[1]}; K3 "
            f"{ms3:.3f} ms, K4 {ms4:.3f} ms")
        if not (e_rgb <= K3_RGB_ATOL and e_sig <= K3_SIGMA_REL and shapes_ok
                and max(rel.values()) <= K4_REL_RMS and launched == (1, 1)
                and out_k[2].numel() == net.lay["n_w"]
                and bool(torch.isfinite(rgb_k).all())):
            raise AssertionError(f"K3/K4 on the padded {depth}×{W} net "
                                 "disagree with their plain versions")


def k4_parts(args) -> dict:
    """Device ms of one K4 call by part, from torch.profiler's device
    events: the rows kernel, wgrad, the fixed-order sums, and the rest
    (the weight gather, allocations' fills)."""
    from torch.profiler import ProfilerActivity, profile
    from fashion_nerf_torch.kernels import posenc_mlp
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        posenc_mlp.field_rows_backward(*args)
        torch.cuda.synchronize()
    parts = {"rows": 0.0, "wgrad": 0.0, "sums": 0.0, "other": 0.0}
    for e in prof.key_averages():
        key = ("rows" if "bwd_rows_kernel" in e.key else
               "wgrad" if "wgrad_kernel" in e.key else
               "sums" if "sum_kernel" in e.key or "sum_rows" in e.key
               else "other")
        parts[key] += e.device_time_total / 1e3
    return parts


def wgrad_yardstick(net, n, device) -> float:
    """torch.matmul's ms for K4's weight-gradient products at n rows, one
    Aᵀ·D per weight (bf16 operands and output, cuBLAS): a yardstick of the
    wgrad kernel, used nowhere in the port."""
    lay, W, k0 = net.lay, net.width, net.k0
    shapes = []
    for i in range(net.depth):
        if lay["w_h"][i] is not None:
            shapes.append((W, W))
        if lay["w_a0"][i] is not None:
            shapes.append((k0, W))
    shapes += ([(W, 1), (W, W), (W, W // 2), (W // 2, 3)] if net.has_vd
               else [(W, 4)])
    times = {}
    for a_w, d_w in set(shapes):
        A = torch.randn((n, a_w), device=device, dtype=torch.bfloat16)
        D = torch.randn((n, d_w), device=device, dtype=torch.bfloat16)
        times[a_w, d_w] = cuda_ms(lambda: torch.matmul(A.t(), D))
        del A, D
    torch.cuda.empty_cache()
    return sum(times[x] for x in shapes)


def kernel_k6(cfg, fine, dp, o, d, alive_f, bhit, tf_pad, df_pad, k2_out):
    """K6 at the fine march's main-path shape, the chunk of K2's check:
    against its plain version (rgb, w, acc ≤ K6_ATOL, depth ≤ K6_ATOL·far,
    identical executed (tile, block) pairs) and against K2's outputs."""
    from fashion_nerf_torch.kernels import carrymarch, posenc_mlp
    from fashion_nerf_torch.render.blockwise import march_liveness
    R, S = tf_pad.shape
    NB = bhit.shape[1]
    net = posenc_mlp.pack_params(fine, hoist_x=False)
    hit = alive_f.float().contiguous()
    args = (net, dp, o, d, hit, bhit, tf_pad.contiguous(),
            df_pad.contiguous(), math.log(cfg.kernels.early_term_eps))
    out_k = carrymarch.carry_march(*args)
    out_p = carrymarch.carry_march_plain(*args)
    torch.cuda.synchronize()
    err = {k: maxerr(a, b) for k, a, b in zip(("rgb", "depth", "acc", "w"),
                                              out_k, out_p)}
    live_k = march_liveness(out_k[3], hit, bhit, cfg)["tile_alive"]
    live_p = march_liveness(out_p[3], hit, bhit, cfg)["tile_alive"]
    same_live = bool(torch.equal(live_k, live_p))
    e_k2 = max(maxerr(out_k[0], k2_out[0]), maxerr(out_k[3], k2_out[1]))
    ms = cuda_ms(lambda: carrymarch.carry_march(*args))
    pms = cuda_ms(lambda: carrymarch.carry_march_plain(*args))
    far = cfg.render.far
    b6 = bound(2 * int(live_p.sum()) * 2048 * mlp_macs(net),
               nbytes(dp, o, d, hit, bhit, tf_pad, df_pad, net.w, net.b,
                      *out_k[:4]))
    errs = json.dumps({k: float(f"{v:.3g}") for k, v in err.items()})
    say("kernels", f"K6 carry march, the same chunk ({R} rays × {NB}×"
        f"{S // NB}): max abs err {errs}"
        f" (tol {K6_ATOL}, depth {K6_ATOL * far:g}); executed (tile, block) "
        f"{int(live_k.sum())}/{live_k.numel()}, identical to plain: "
        f"{same_live}; against K2 rgb/w {e_k2:.3g} (tol {K6_ATOL}); kernel "
        f"{ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b6, ms)}")
    ok = (max(err["rgb"], err["acc"], err["w"]) <= K6_ATOL
          and err["depth"] <= K6_ATOL * far and same_live
          and e_k2 <= K6_ATOL and 0 < int(live_k.sum()) < live_k.numel()
          and bool(torch.isfinite(out_k[0]).all()))
    if not ok:
        raise AssertionError("K6 disagrees with its plain version or K2")
    return dict(max_abs_err=max(err.values()), ms=ms, plain_ms=pms, **b6)


def cond_tree(tree, cc: int, rng):
    """A field tree with cc cond rows of N(0, TRYON_COND_STD²) inserted at
    rows [cx, cx + cc) of trunk_0 and of the skip layer: the reference's
    layout of a conditioned NeRFMLP ([γ(x) | cond] and [γ(x) | cond | h])."""
    p = {k: dict(v) for k, v in tree["params"].items()}
    cx, width = p["trunk_0"]["kernel"].shape
    for name, leaf in p.items():
        k = leaf["kernel"]
        if name == "trunk_0" or (name.startswith("trunk_")
                                 and k.shape[0] == cx + width):
            rows = rng.normal(0.0, TRYON_COND_STD, (cc, width))
            leaf["kernel"] = np.concatenate(
                [k[:cx], rows.astype(np.float32), k[cx:]])
    return {"params": p}


def kernel_cond(cfg, trained, pts, dirs, chunk, results, device):
    """K3, K2 and K6 on the conditioned flagship (cond_tree of the
    committed fine net, TRYON_CC cond rows): K3 at the sweep's 65,536 rows
    with a cond per ray through its cond window; K2 (the cond folded into
    oX) and K6 (its cond window) on the 8192-ray chunk of K2's check with
    one scene cond vector, at the conditioned tile of 1024 rows. Each
    against its plain version with the unconditioned checks' tolerances
    and identical executed (tile, block) pairs; times beside the
    unconditioned kernels'. The bound is the unconditioned work (the cond
    is hoisted) plus the condpart's bytes."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.kernels import carrymarch, posenc_mlp, slimmarch
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.render.blockwise import march_liveness
    rng = np.random.default_rng(21)
    fine = load_flax_params(cond_tree(trained["fine"], TRYON_CC, rng),
                            compute_dtype="bfloat16", device=device,
                            cond_dim=TRYON_CC)
    out = {}

    # K3: 1024 rays × 64 samples, a cond vector per ray
    net = posenc_mlp.pack_params(fine, hoist_x=False)
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    cond = torch.from_numpy(rng.normal(size=(dirs.shape[0], TRYON_CC)).astype(
        np.float32)).to(device)
    cp = posenc_mlp.hoist_cond(net, cond)
    rgb_k, sig_k = posenc_mlp.field_rows(net, pts, dp, 64, cp)
    rgb_p, sig_p = posenc_mlp.field_rows_plain(net, pts, dp, 64, cp)
    rgb_0, _ = posenc_mlp.field_rows(net, pts, dp, 64, torch.zeros_like(cp))
    torch.cuda.synchronize()
    row_err = (rgb_k - rgb_p).abs().amax(dim=1)
    e_rgb = float(row_err.max())
    share = float((row_err > K3_RGB_ATOL).float().mean())
    e_sig = float(((sig_k - sig_p).abs() / (1 + sig_p.abs())).max())
    moved = maxerr(rgb_k, rgb_0)
    ms = cuda_ms(lambda: posenc_mlp.field_rows(net, pts, dp, 64, cp))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_plain(net, pts, dp, 64, cp))
    b3 = bound(2 * pts.shape[0] * mlp_macs(net),
               nbytes(pts, dp, cp, net.w, net.b, rgb_k, sig_k))
    say("kernels", f"K3 field with the cond window, 65536 rows (condpart "
        f"{tuple(cp.shape)} bf16): rgb err max {e_rgb:.3g} (tol "
        f"{K3_RGB_MAX}), rows over {K3_RGB_ATOL} {share:.5f} (tol "
        f"{K3_ROW_SHARE}), σ rel err {e_sig:.3g}; the cond moves rgb by "
        f"{moved:.3g}; kernel {ms:.3f} ms (unconditioned "
        f"{results['field']['ms']:.3f}), plain {pms:.3f} ms; "
        f"{bound_line(b3, ms)}")
    if not (e_rgb <= K3_RGB_MAX and share <= K3_ROW_SHARE
            and e_sig <= K3_SIGMA_REL and moved > 1e-3):
        raise AssertionError("K3 with a cond disagrees with its plain version")
    out["field_cond"] = dict(max_abs_err=e_rgb, ms=ms, plain_ms=pms, **b3)
    del rgb_k, rgb_p, rgb_0, sig_k, sig_p

    # K2 and K6: the chunk, one scene cond vector, the halved tile
    o, d, alive_f, bhit, tf_pad, df_pad = chunk
    R, S = tf_pad.shape
    NB = bhit.shape[1]
    SB = S // NB
    log_eps = math.log(cfg.kernels.early_term_eps)
    scene_cond = torch.from_numpy(rng.normal(size=(1, TRYON_CC)).astype(
        np.float32)).to(device).expand(R, TRYON_CC)
    fnet = slimmarch.split_hoist(fine)
    cnet = posenc_mlp.pack_params(fine, hoist_x=False)
    if not fnet.tile_rows == cnet.tile_rows == K.TILE_ROWS // 2:
        raise AssertionError("a conditioned net must march the halved tile")
    cpr = posenc_mlp.hoist_cond(fnet, scene_cond)
    hf = slimmarch.hoist_rays(fnet, o, d, cpr)
    dpr = posenc_mlp.hoist_dirs(fnet, d).contiguous()
    hit = alive_f.float().contiguous()
    args2 = (fnet, hf, dpr, hit, bhit, tf_pad.contiguous(),
             df_pad.contiguous(), log_eps)
    args6 = (cnet, dpr, o, d, hit, bhit, tf_pad.contiguous(),
             df_pad.contiguous(), log_eps)
    s_k, s_p = slimmarch.slim_march(*args2), slimmarch.slim_march_plain(*args2)
    c_k = carrymarch.carry_march(*args6, condpart=cpr)
    c_p = carrymarch.carry_march_plain(*args6, condpart=cpr)
    torch.cuda.synchronize()
    tile = K.TILE_ROWS // 2

    def executed(w):
        return march_liveness(w, hit, bhit, cfg, tile_rows=tile)["tile_alive"]

    ex = {k: executed(w) for k, w in (("K2", s_k[1]), ("K2 plain", s_p[1]),
                                       ("K6", c_k[3]), ("K6 plain", c_p[3]))}
    full = march_liveness(s_k[1], hit, bhit, cfg)["tile_alive"]
    same = {k: bool(torch.equal(v, ex["K2 plain"])) for k, v in ex.items()}
    e2 = max(maxerr(s_k[0], s_p[0]), maxerr(s_k[1], s_p[1]))
    e6 = {k: maxerr(a, b) for k, a, b in zip(("rgb", "depth", "acc", "w"),
                                             c_k, c_p)}
    e62 = max(maxerr(c_k[0], s_k[0]), maxerr(c_k[3], s_k[1]))
    n_ex = int(ex["K2 plain"].sum())
    ms2 = cuda_ms(lambda: slimmarch.slim_march(*args2))
    pms2 = cuda_ms(lambda: slimmarch.slim_march_plain(*args2))
    ms6 = cuda_ms(lambda: carrymarch.carry_march(*args6, condpart=cpr))
    pms6 = cuda_ms(lambda: carrymarch.carry_march_plain(*args6, condpart=cpr))
    b2 = bound(2 * n_ex * tile * mlp_macs(fnet),
               nbytes(hit, bhit, *hf, dpr, tf_pad, df_pad, fnet.w, fnet.b,
                      s_k[0], s_k[1], s_k[2]))
    b6 = bound(2 * n_ex * tile * mlp_macs(cnet),
               nbytes(dpr, cpr, o, d, hit, bhit, tf_pad, df_pad, cnet.w,
                      cnet.b, *c_k[:4]))
    far = cfg.render.far
    say("kernels", f"K2 fine march with a cond (in oX) and K6 with its cond "
        f"window, the same chunk ({R} rays × {NB}×{SB}) at the conditioned "
        f"tile of {tile // SB} rays: K2 rgb/w err {e2:.3g}, K6 "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in e6.items()})} (tol "
        f"{K2_ATOL}, depth {K6_ATOL * far:g}), K6 against K2 {e62:.3g}; "
        f"executed (tile, block) {n_ex}/{ex['K2'].numel()} (at the 64-ray "
        f"tile {int(full.sum())}/{full.numel()}), identical to plain: "
        f"{same}; K2 {ms2:.3f} ms (unconditioned "
        f"{results['slim_march']['ms']:.3f}), plain {pms2:.3f} ms, "
        f"{bound_line(b2, ms2)}; K6 {ms6:.3f} ms (unconditioned "
        f"{results['carry_march']['ms']:.3f}), plain {pms6:.3f} ms, "
        f"{bound_line(b6, ms6)}")
    ok = (e2 <= K2_ATOL and all(same.values()) and e62 <= K6_ATOL
          and max(e6["rgb"], e6["acc"], e6["w"]) <= K6_ATOL
          and e6["depth"] <= K6_ATOL * far and 0 < n_ex < ex["K2"].numel()
          and bool(torch.isfinite(s_k[0]).all())
          and bool(torch.isfinite(c_k[0]).all()))
    if not ok:
        raise AssertionError("K2 or K6 with a cond disagrees with its plain "
                             "version")
    out["slim_march_cond"] = dict(max_abs_err=e2, ms=ms2, plain_ms=pms2, **b2)
    out["carry_march_cond"] = dict(max_abs_err=max(e6.values()), ms=ms6,
                                   plain_ms=pms6, **b6)
    return out


def kernel_probe(device):
    """P1 and P2 against their plain chains at the probe's shapes (2^21
    rows for P1, 2^20 for P2), each distinct launch once: relative RMS ≤
    PROBE_REL_RMS, every element within PROBE_MAX_REL·max|plain|. The
    kernels line's rows are P1's chain+relu (the field's trunk, each layer
    stored in shared memory as the field kernels store it) and P2's
    w256 d9 dependent; P1's chain f32hold (the activations held in
    registers) is timed beside them."""
    from fashion_nerf_torch import probe
    cases = [("probe_p1", name, probe.P1_ROWS, probe.P1_WIDTH,
              probe.P1_DEPTH, mode, relu, 0.06)
             for name, mode, relu, same in probe.P1_VARIANTS if not same]
    cases += [("probe_p2", name, probe.P2_ROWS, w, dep, mode, False, 0.05)
              for name, w, dep, mode, same in probe.P2_SHAPES if not same]
    # timed rows; the first two are the kernels line's P1 and P2
    timed = ("chain+relu", "w256 d9 dependent", "chain f32hold")
    out = {"probe_p1": dict(max_abs_err=0.0), "probe_p2":
           dict(max_abs_err=0.0)}
    for key, name, n, w, dep, mode, relu, scale in cases:
        x, ws = probe.make_inputs(n, w, dep, scale, 7, device)
        got = probe.tc_chain(x, ws, mode, relu)
        want = probe.tc_chain_plain(x, ws, mode, relu)
        torch.cuda.synchronize()
        e_abs = maxerr(got, want)
        rel = rel_rms(got, want)
        peak = float(want.abs().max())
        say("kernels", f"{key} {name} ({n} rows): relative RMS {rel:.3g} "
            f"(tol {PROBE_REL_RMS}), max abs err {e_abs:.3g} against "
            f"max |plain| {peak:.3g} (tol {PROBE_MAX_REL}·max)")
        if not (rel <= PROBE_REL_RMS and e_abs <= PROBE_MAX_REL * peak
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{key} {name} disagrees with its plain "
                                 "version")
        out[key]["max_abs_err"] = max(out[key]["max_abs_err"], e_abs)
        del got, want
        if name in timed:
            ms = cuda_ms(lambda: probe.tc_chain(x, ws, mode, relu))
            pms = cuda_ms(lambda: probe.tc_chain_plain(x, ws, mode, relu))
            bp = bound(2 * n * dep * w * w, nbytes(x, *ws) + n * w * 4)
            say("kernels", f"{key} {name}: kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms; {bound_line(bp, ms)}")
            if name in timed[:2]:
                out[key].update(ms=ms, plain_ms=pms, **bp)
        del x, ws
        torch.cuda.empty_cache()
    return out


def kernel_k4(net, rng, device):
    """K4 at the fine net's shape in a training step: 4096 rays × 192
    samples = 786,432 rows, random cotangents of a loss's scale."""
    from fashion_nerf_torch.kernels import posenc_mlp
    R, S = 4096, 192
    n = R * S
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(R, 3)).astype(
        np.float32)).to(device)
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    g_rgb = torch.from_numpy((1e-4 * rng.normal(size=(n, 3))).astype(
        np.float32)).to(device)
    g_sig = torch.from_numpy((1e-4 * rng.normal(size=n)).astype(
        np.float32)).to(device)
    args = (net, pts, dp, g_rgb, g_sig, S)
    out_k = posenc_mlp.field_rows_backward(*args)
    out_k2 = posenc_mlp.field_rows_backward(*args)
    out_p = posenc_mlp.field_rows_backward_plain(*args)
    torch.cuda.synchronize()
    names = ("d_pts", "d_dir", "d_w", "d_b")
    rel = {k: rel_rms(a, b) for k, a, b in zip(names, out_k, out_p)}
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    e_abs = max(maxerr(a, b) for a, b in zip(out_k, out_p))
    finite = all(bool(torch.isfinite(a).all()) for a in out_k)
    # forward recompute, dgrad and wgrad: three passes of the net's MACs
    b4 = bound(3 * 2 * n * mlp_macs(net),
               nbytes(pts, dp, g_rgb, g_sig, net.w, net.b, *out_k))
    del out_k, out_k2, out_p
    ms = cuda_ms(lambda: posenc_mlp.field_rows_backward(*args))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_backward_plain(*args))
    torch.cuda.empty_cache()
    parts = k4_parts(args)
    cublas = wgrad_yardstick(net, n, device)
    # this design's own floor: the bf16 workspace written once, read once
    ws_ms = 2 * n * posenc_mlp.bwd_workspace_cols(net) * 2 / HBM_BPS * 1e3
    say("kernels", f"K4 field backward {n} rows ({R} rays × {S}): relative "
        f"RMS against plain {json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})}"
        f" (tol {K4_REL_RMS} each); bitwise equal over two runs: {same}; "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b4, ms)}")
    say("kernels", f"K4 parts (device ms, torch.profiler, one call): rows "
        f"kernel {parts['rows']:.3f}, wgrad {parts['wgrad']:.3f}, sums "
        f"{parts['sums']:.3f}, other {parts['other']:.3f}; workspace floor "
        f"{ws_ms:.3f} ms ({posenc_mlp.bwd_workspace_cols(net) * 2} bytes a "
        f"row, written and read once); yardstick torch.matmul for the same "
        f"wgrad products {cublas:.3f} ms")
    if not (max(rel.values()) <= K4_REL_RMS and same and finite):
        raise AssertionError("K4 disagrees with its plain version or is "
                             "not deterministic")
    return dict(max_abs_err=e_abs, ms=ms, plain_ms=pms, **b4)


def kernel_k4_cond(trained, results, device):
    """K4's conditioned plan on viton_tryon's fixture fine net (the
    committed fine net with TRYON_CC cond rows, cond_tree) at the try-on
    step's fine shape: 2048 rays × 192 samples = 393,216 rows, a condpart
    of 2048 × 512 bf16 (a cond per ray), cotangents of a loss's scale;
    twice (bitwise) and against its plain version, each of the five
    outputs (d_condpart included) to K4_REL_RMS; timed beside its plain
    version, with its parts. Then the sparsity prior's shape (1024 rays ×
    1 sample) and a zero-padded conditioned 3×32 net (L = 4, a 16-wide
    cond into trunk_0 and the skip layer; 1024 rays × 64), each against its
    plain version."""
    from fashion_nerf_torch.kernels import posenc_mlp
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    rng = np.random.default_rng(31)
    names = ("d_pts", "d_dir", "d_w", "d_b", "d_cond")

    def inputs(net, R, S):
        n = R * S
        cc = net.cond_kernel.shape[0]

        def t(a):
            return torch.from_numpy(a.astype(np.float32)).to(device)
        pts = t(rng.uniform(-1.2, 1.2, (n, 3)))
        dp = posenc_mlp.hoist_dirs(net, t(rng.normal(size=(R, 3))))
        cp = posenc_mlp.hoist_cond(net, t(rng.normal(size=(R, cc))))
        return (net, pts, dp.contiguous(), t(1e-4 * rng.normal(size=(n, 3))),
                t(1e-4 * rng.normal(size=n)), S, cp)

    def check(args, label):
        out_k = posenc_mlp.field_rows_backward(*args)
        out_k2 = posenc_mlp.field_rows_backward(*args)
        out_p = posenc_mlp.field_rows_backward_plain(*args)
        torch.cuda.synchronize()
        rel = {k: rel_rms(a, b) for k, a, b in zip(names, out_k, out_p)}
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        e_abs = max(maxerr(a, b) for a, b in zip(out_k, out_p))
        ok = (len(out_k) == 5 and max(rel.values()) <= K4_REL_RMS and same
              and all(a.shape == b.shape for a, b in zip(out_k, out_p))
              and all(bool(torch.isfinite(a).all()) for a in out_k))
        say("kernels", f"K4 with the cond, {label}: relative RMS against "
            f"plain {json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})}"
            f" (tol {K4_REL_RMS} each); bitwise equal over two runs: {same}")
        if not ok:
            raise AssertionError(f"K4 with the cond ({label}) disagrees with "
                                 "its plain version or is not deterministic")
        return out_k, e_abs

    fine = load_flax_params(cond_tree(trained["fine"], TRYON_CC, rng),
                            compute_dtype="bfloat16", device=device,
                            cond_dim=TRYON_CC)
    net = posenc_mlp.pack_params(fine, hoist_x=False)
    R, S = 2048, 192
    n = R * S
    args = inputs(net, R, S)
    out_k, e_abs = check(args, f"{n} rows ({R} rays × {S}, condpart "
                         f"{tuple(args[6].shape)} bf16)")
    b4 = bound(3 * 2 * n * mlp_macs(net),
               nbytes(*args[1:5], args[6], net.w, net.b, *out_k))
    del out_k
    ms = cuda_ms(lambda: posenc_mlp.field_rows_backward(*args))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_backward_plain(*args))
    torch.cuda.empty_cache()
    parts = k4_parts(args)
    ms_u = results["field_bwd"]["ms"]
    say("kernels", f"K4 with the cond {n} rows: kernel {ms:.3f} ms (the "
        f"unconditioned K4 {ms_u:.3f} ms at 786,432 rows, {ms_u / 2:.3f} per "
        f"{n}), plain {pms:.3f} ms; {bound_line(b4, ms)}; parts (device ms, "
        f"torch.profiler, one call): rows kernel {parts['rows']:.3f}, wgrad "
        f"{parts['wgrad']:.3f}, sums {parts['sums']:.3f}, other "
        f"{parts['other']:.3f}")
    check(inputs(net, 1024, 1), "the sparsity prior's 1024 rows (1 sample a "
          "ray)")
    cx, W = 27, 32
    shapes = {"trunk_0": (cx + 16, W), "trunk_1": (W, W),
              "trunk_2": (cx + 16 + W, W), "sigma_head": (W, 1),
              "feature": (W, W), "view_0": (W + 27, W // 2),
              "rgb_head": (W // 2, 3)}
    small = load_flax_params(random_tree({"params": {
        k: {"kernel": np.empty(v), "bias": np.empty(v[1])}
        for k, v in shapes.items()}}, rng), compute_dtype="bfloat16",
        device=device, cond_dim=16)
    snet = posenc_mlp.pack_params(small, hoist_x=False)
    big = posenc_mlp.kernel_net(snet)
    check(inputs(snet, 1024, 64), f"a 3×{W} net (L = 4, cond 16) padded to "
          f"{big.depth}×{big.width}, 65536 rows")
    return dict(max_abs_err=e_abs, ms=ms, plain_ms=pms, **b4)


def skip_tree(rng, W=256, L=10, depth=8, skips=(2, 4), cc=0, vd=True):
    """A random field tree (random_tree's draws) whose layers after
    `skips` take γ(x) beside the activations, and trunk_0's and theirs cc
    cond rows: the reference's NeRFMLP layout with several skip layers."""
    cx = 3 * (2 * L + 1) + cc
    shapes = {f"trunk_{i}": ((cx + W) if (i - 1) in skips else
                             (cx if i == 0 else W), W) for i in range(depth)}
    if vd:
        shapes.update(sigma_head=(W, 1), feature=(W, W),
                      view_0=(W + 27, W // 2), rgb_head=(W // 2, 3))
    else:
        shapes["out_head"] = (W, 4)
    return random_tree({"params": {
        k: {"kernel": np.empty(v), "bias": np.empty(v[1])}
        for k, v in shapes.items()}}, rng)


def check_layout(net):
    """fnt::make_layout (the library's fnt_layout) equals the packed net's
    `_layout` offset for offset."""
    import ctypes
    from fashion_nerf_torch import kernels as K
    lay = net.lay
    out = (ctypes.c_int * (3 * net.depth + 10))()
    err = K.library().fnt_layout(net.depth, net.width, net.k0,
                                 net.skip_mask, int(net.has_vd), out)
    want = [(-1 if v is None else v) for v in
            lay["w_h"] + lay["w_a0"] + lay["b"]]
    want += [lay.get(k, -1) for k in ("w_sig", "w_feat", "w_view", "w_rgb",
                                      "w_out", "b_sig", "b_feat", "b_view",
                                      "b_rgb", "b_out")]
    if err or list(out) != want:
        raise AssertionError(f"fnt_layout {list(out)} (error {err}) is not "
                             f"_layout {want}")


def kernel_k3_rows(net, pts, dirs, spr, cp, label):
    """K3 against its plain version on a random net: rgb ≤ K3_RGB_ATOL on
    every row, σ ≤ K3_SIGMA_REL; time, plain time and bound."""
    from fashion_nerf_torch.kernels import posenc_mlp
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    (rgb_k, sig_k), (rgb_p, sig_p) = (
        posenc_mlp.field_rows(net, pts, dp, spr, cp),
        posenc_mlp.field_rows_plain(net, pts, dp, spr, cp))
    torch.cuda.synchronize()
    e_rgb = maxerr(rgb_k, rgb_p)
    e_sig = float(((sig_k - sig_p).abs() / (1 + sig_p.abs())).max())
    ms = cuda_ms(lambda: posenc_mlp.field_rows(net, pts, dp, spr, cp))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_plain(net, pts, dp, spr, cp))
    b = bound(2 * pts.shape[0] * mlp_macs(net),
              nbytes(pts, dp, *(() if cp is None else (cp,)), net.w, net.b,
                     rgb_k, sig_k))
    say("kernels", f"K3 field, {label}, {pts.shape[0]} rows: rgb err "
        f"{e_rgb:.3g} (tol {K3_RGB_ATOL} on every row), σ rel err "
        f"{e_sig:.3g} (tol {K3_SIGMA_REL}); kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms; {bound_line(b, ms)}")
    if not (e_rgb <= K3_RGB_ATOL and e_sig <= K3_SIGMA_REL
            and bool(torch.isfinite(rgb_k).all())):
        raise AssertionError(f"K3 ({label}) disagrees with its plain version")
    return dict(max_abs_err=e_rgb, ms=ms, plain_ms=pms, **b)


def kernel_k4_rows(net, R, S, rng, device, label, cc=0):
    """K4 against its plain version at R rays × S samples, cotangents of a
    loss's scale (and a cond per ray with cc > 0): every output within
    K4_REL_RMS relative RMS, bitwise the same over two runs; time, plain
    time and bound."""
    from fashion_nerf_torch.kernels import posenc_mlp
    n = R * S

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)
    pts = t(rng.uniform(-1.2, 1.2, (n, 3)))
    dp = posenc_mlp.hoist_dirs(net, t(rng.normal(size=(R, 3)))).contiguous()
    cp = (posenc_mlp.hoist_cond(net, t(rng.normal(size=(R, cc))))
          if cc else None)
    args = (net, pts, dp, t(1e-4 * rng.normal(size=(n, 3))),
            t(1e-4 * rng.normal(size=n)), S, cp)
    out_k = posenc_mlp.field_rows_backward(*args)
    out_k2 = posenc_mlp.field_rows_backward(*args)
    out_p = posenc_mlp.field_rows_backward_plain(*args)
    torch.cuda.synchronize()
    names = ("d_pts", "d_dir", "d_w", "d_b", "d_cond")
    rel = {k: rel_rms(a, b) for k, a, b in zip(names, out_k, out_p)}
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    e_abs = max(maxerr(a, b) for a, b in zip(out_k, out_p))
    finite = all(bool(torch.isfinite(a).all()) for a in out_k)
    b4 = bound(3 * 2 * n * mlp_macs(net),
               nbytes(*args[1:5], *(() if cp is None else (cp,)), net.w,
                      net.b, *out_k))
    del out_k, out_k2, out_p
    ms = cuda_ms(lambda: posenc_mlp.field_rows_backward(*args))
    pms = cuda_ms(lambda: posenc_mlp.field_rows_backward_plain(*args))
    torch.cuda.empty_cache()
    say("kernels", f"K4 field backward, {label}, {n} rows ({R} rays × {S})"
        f": relative RMS against plain "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})} (tol"
        f" {K4_REL_RMS} each); bitwise equal over two runs: {same}; kernel "
        f"{ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b4, ms)}")
    if not (max(rel.values()) <= K4_REL_RMS and same and finite
            and len(rel) == (5 if cc else 4)):
        raise AssertionError(f"K4 ({label}) disagrees with its plain version "
                             "or is not deterministic")
    return dict(max_abs_err=e_abs, ms=ms, plain_ms=pms, **b4)


def kernel_march_rows(cfg, model, chunk, label, k6=True):
    """K2 (and K6) on `model` at the fine march's chunk (K2's check, 8192
    rays × 3×32): each against its plain version (K2_ATOL; K6 also
    against K2) with identical executed (tile, block) pairs; times, plain
    times and bounds."""
    from fashion_nerf_torch.kernels import carrymarch, posenc_mlp, slimmarch
    from fashion_nerf_torch.render.blockwise import march_liveness
    o, d, alive_f, bhit, tf_pad, df_pad = chunk
    R, S = tf_pad.shape
    NB = bhit.shape[1]
    hit = alive_f.float().contiguous()
    log_eps = math.log(cfg.kernels.early_term_eps)
    snet = slimmarch.split_hoist(model)
    hf = slimmarch.hoist_rays(snet, o, d)
    dp = posenc_mlp.hoist_dirs(snet, d).contiguous()
    args2 = (snet, hf, dp, hit, bhit, tf_pad.contiguous(),
             df_pad.contiguous(), log_eps)
    s_k, s_p = slimmarch.slim_march(*args2), slimmarch.slim_march_plain(*args2)
    torch.cuda.synchronize()
    ex = [march_liveness(w, hit, bhit, cfg)["tile_alive"]
          for w in (s_k[1], s_p[1])]
    n_ex = int(ex[1].sum())
    e2 = max(maxerr(s_k[0], s_p[0]), maxerr(s_k[1], s_p[1]))
    ms2 = cuda_ms(lambda: slimmarch.slim_march(*args2))
    pms2 = cuda_ms(lambda: slimmarch.slim_march_plain(*args2))
    b2 = bound(2 * n_ex * 2048 * mlp_macs(snet),
               nbytes(hit, bhit, *hf, dp, tf_pad, df_pad, snet.w, snet.b,
                      *s_k))
    same = bool(torch.equal(ex[0], ex[1]))
    out = {"K2": dict(max_abs_err=e2, ms=ms2, plain_ms=pms2, **b2)}
    line = (f"K2 {ms2:.3f} ms, plain {pms2:.3f} ms, {bound_line(b2, ms2)}")
    ok = (e2 <= K2_ATOL and same and 0 < n_ex < ex[0].numel()
          and bool(torch.isfinite(s_k[0]).all()))
    if k6:
        cnet = posenc_mlp.pack_params(model, hoist_x=False)
        args6 = (cnet, dp, o, d, hit, bhit, tf_pad.contiguous(),
                 df_pad.contiguous(), log_eps)
        c_k = carrymarch.carry_march(*args6)
        c_p = carrymarch.carry_march_plain(*args6)
        torch.cuda.synchronize()
        ex6 = march_liveness(c_k[3], hit, bhit, cfg)["tile_alive"]
        e6 = max(maxerr(c_k[0], c_p[0]), maxerr(c_k[2], c_p[2]),
                 maxerr(c_k[3], c_p[3]))
        e62 = max(maxerr(c_k[0], s_k[0]), maxerr(c_k[3], s_k[1]))
        ms6 = cuda_ms(lambda: carrymarch.carry_march(*args6))
        pms6 = cuda_ms(lambda: carrymarch.carry_march_plain(*args6))
        b6 = bound(2 * n_ex * 2048 * mlp_macs(cnet),
                   nbytes(dp, o, d, hit, bhit, tf_pad, df_pad, cnet.w,
                          cnet.b, *c_k[:4]))
        same = same and bool(torch.equal(ex6, ex[1]))
        out["K6"] = dict(max_abs_err=e6, ms=ms6, plain_ms=pms6, **b6)
        line += (f"; K6 rgb/acc/w err {e6:.3g}, against K2 {e62:.3g}, "
                 f"{ms6:.3f} ms, plain {pms6:.3f} ms, {bound_line(b6, ms6)}")
        ok = (ok and e6 <= K6_ATOL and e62 <= K6_ATOL and same
              and bool(torch.isfinite(c_k[0]).all()))
    say("kernels", f"{label}, the chunk ({R} rays × {NB}×{S // NB}): K2 "
        f"rgb/w err {e2:.3g} (tol {K2_ATOL}); executed (tile, block) "
        f"{n_ex}/{ex[0].numel()}, identical to plain: {same}; {line}")
    if not ok:
        raise AssertionError(f"{label}: a march disagrees with its plain "
                             "version")
    return out


def kernel_sigma_widths(args1, o, d, device):
    """The σ march at the spec sweep's wider proposals (2×192 and 3×256 at
    L = 8, random), K1's chunk (8192 rays × 64): the kernel `sigma_kernel`
    names (K2 without a view branch, zero-padded to 256) against the plain
    version on the unpadded net (K1_ATOL), with identical executed tiles
    and launches counted under "sigma_march_k2" only."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.kernels import sigmamarch
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    _, _, alive, t_pad, d_pad = args1
    R, SB = t_pad.shape
    rpt = K.TILE_ROWS // SB
    rng = np.random.default_rng(41)
    out = {}
    for W, depth in ((192, 2), (256, 3)):
        cx = 3 * (2 * 8 + 1)
        shapes = {"trunk_0": (cx, W), "out_head": (W, 4)}
        shapes.update({f"trunk_{i}": (W, W) for i in range(1, depth)})
        model = load_flax_params(random_tree({"params": {
            k: {"kernel": np.empty(v), "bias": np.empty(v[1])}
            for k, v in shapes.items()}}, rng), compute_dtype="bfloat16",
            device=device)
        net = sigmamarch.pack_sigma(model)
        served = sigmamarch.sigma_kernel(net)
        hz = sigmamarch.hoist_rays(net, o, d)
        args = (net, hz, alive, t_pad, d_pad)
        n0 = dict(K.LAUNCHES)
        w_k, acc_k, lt_k = sigmamarch.sigma_march(*args)
        moved = {k for k in K.LAUNCHES if K.LAUNCHES[k] != n0[k]}
        w_p, acc_p, _ = sigmamarch.sigma_march_plain(*args)
        torch.cuda.synchronize()
        e = max(maxerr(w_k, w_p), maxerr(acc_k, acc_p))
        live = (alive.view(-1, rpt) > 0).any(dim=1)
        tiles_k = (w_k.view(-1, rpt * SB) != 0).any(dim=1)
        tiles_p = (w_p.view(-1, rpt * SB) != 0).any(dim=1)
        same = bool(torch.equal(tiles_k, tiles_p))
        n_live = int(live.sum())
        ms = cuda_ms(lambda: sigmamarch.sigma_march(*args))
        pms = cuda_ms(lambda: sigmamarch.sigma_march_plain(*args))
        b = bound(2 * n_live * K.TILE_ROWS * mlp_macs(net),
                  nbytes(alive, *hz, t_pad, d_pad, net.w, net.b, w_k, acc_k,
                         lt_k))
        say("kernels", f"σ march, proposal {depth}×{W} L = 8 (random), K1's "
            f"chunk ({R} rays × {SB}): served by {served} (launches moved "
            f"{sorted(moved)}); w/acc err {e:.3g} (tol {K1_ATOL}) against "
            f"plain on the unpadded net; tiles with a nonzero weight "
            f"{int(tiles_k.sum())}, identical to plain: {same}; live tiles "
            f"{n_live}/{live.numel()}; kernel {ms:.3f} ms (a wrapper call), "
            f"plain {pms:.3f} ms; {bound_line(b, ms)} (the unpadded net's "
            f"operations)")
        if not (served == "K2" and moved == {"sigma_march_k2"}
                and e <= K1_ATOL and same and 0 < n_live < live.numel()
                and bool(torch.isfinite(w_k).all())):
            raise AssertionError(f"the σ march at {depth}×{W} disagrees with "
                                 "its plain version")
        out[(W, depth)] = dict(max_abs_err=e, ms=ms, plain_ms=pms, **b)
    return out


def kernel_skips(cfg, pts, dirs, chunk, args1, device):
    """The repaired shapes at full width, random nets: an 8×256 L = 10
    field with skips (2, 4), so that layers 3 and 5 take γ(x) (and, with a
    64-wide cond, n_cond = 3), through K3 (65,536 rows, the cond window
    too), K4 (786,432 rows; conditioned 393,216), K2 and K6 (the fine
    march's chunk); K2 with a view branch on an 8×128 net; the σ march at
    the sweep's wider proposals. → the σ march's 2×192 row (the JSON's
    sigma_march_k2)."""
    from fashion_nerf_torch.kernels import posenc_mlp
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    rng = np.random.default_rng(40)
    model = load_flax_params(skip_tree(rng), compute_dtype="bfloat16",
                             device=device)
    net = posenc_mlp.pack_params(model, hoist_x=False)
    check_layout(net)
    if net.skips != (3, 5) or len(posenc_mlp.pack_params(
            model, hoist_x=True).x_kernels) != 3:
        raise AssertionError(f"skips {net.skips}: expected layers 3 and 5")
    kernel_k3_rows(net, pts, dirs, 64, None, "8×256 with skips (2, 4)")
    cmodel = load_flax_params(skip_tree(rng, cc=TRYON_CC),
                              compute_dtype="bfloat16", device=device,
                              cond_dim=TRYON_CC)
    cnet = posenc_mlp.pack_params(cmodel, hoist_x=False)
    check_layout(cnet)
    cp = posenc_mlp.hoist_cond(cnet, torch.from_numpy(rng.normal(size=(
        dirs.shape[0], TRYON_CC)).astype(np.float32)).to(device))
    if cnet.n_cond != 3:
        raise AssertionError(f"n_cond {cnet.n_cond}: expected 3")
    kernel_k3_rows(cnet, pts, dirs, 64, cp, "8×256 with skips (2, 4) and the "
                   f"cond window (Cc {TRYON_CC}, n_cond 3)")
    kernel_k4_rows(net, 4096, 192, rng, device, "8×256 with skips (2, 4)")
    kernel_k4_rows(cnet, 2048, 192, rng, device, "8×256 with skips (2, 4), "
                   f"conditioned (Cc {TRYON_CC}, n_cond 3)", cc=TRYON_CC)
    kernel_march_rows(cfg, model, chunk, "K2 and K6, 8×256 with skips "
                      "(2, 4)")
    narrow = load_flax_params(skip_tree(rng, W=128, skips=(4,)),
                              compute_dtype="bfloat16", device=device)
    kernel_march_rows(cfg, narrow, chunk, "K2 with a view branch at width "
                      "128 (8×128 L = 10, skip (4,))", k6=False)
    kernel_k4_rows(posenc_mlp.pack_params(narrow, hoist_x=False), 4096, 192,
                   rng, device, "8×128 L = 10, skip (4,)")
    cnarrow = load_flax_params(skip_tree(rng, W=128, skips=(4,), cc=TRYON_CC),
                               compute_dtype="bfloat16", device=device,
                               cond_dim=TRYON_CC)
    kernel_k4_rows(posenc_mlp.pack_params(cnarrow, hoist_x=False), 2048, 192,
                   rng, device, f"8×128 L = 10, skip (4,), conditioned (Cc "
                   f"{TRYON_CC}, n_cond 2)", cc=TRYON_CC)
    return kernel_sigma_widths(args1, *chunk[:2], device)[(192, 2)]


def kernel_k5(cfg, rng, device):
    """K5 at the eval shape: 8192 rays × 192 samples over [near, far]."""
    from fashion_nerf_torch.kernels import render
    R, S = 8192, 192
    near, far = cfg.render.near, cfg.render.far
    t = np.sort(rng.uniform(near, far, (R, S)), axis=1).astype(np.float32)
    t = torch.from_numpy(t).to(device)
    sigma = torch.from_numpy(rng.normal(0.0, 20.0, (R, S)).astype(
        np.float32)).to(device)
    rgb = torch.from_numpy(rng.uniform(0, 1, (R, S, 3)).astype(
        np.float32)).to(device)
    dnorm = torch.from_numpy(rng.uniform(0.9, 1.2, R).astype(
        np.float32)).to(device)
    args = (rgb, sigma, t, dnorm, cfg.render.white_bkgd)
    out_k = render.volrend(*args)
    out_p = render.volrend_plain(*args)
    torch.cuda.synchronize()
    err = {k: maxerr(a, b) for k, a, b in zip(("rgb", "depth", "acc",
                                               "weights"), out_k, out_p)}
    call_ms = cuda_ms(lambda: render.volrend(*args))
    dev5 = device_ms(lambda: render.volrend(*args), "volrend_kernel")
    ms = dev5["cold"]
    pms = cuda_ms(lambda: render.volrend_plain(*args))
    # yardstick of the memory system, used nowhere in the port: the rate of
    # torch's device copy of 256 MB (read and written), and K5's bytes at
    # that rate
    src = torch.empty(64 * 2 ** 20, device=device)
    dst = torch.empty_like(src)
    rate = 2 * nbytes(src) / (cuda_ms(lambda: dst.copy_(src)) * 1e-3)
    copy_ms = nbytes(rgb, sigma, t, dnorm, *out_k) / rate * 1e3
    del src, dst
    # ~20 float32 operations a sample (δ, α, the floor, the scan, w, four
    # sums) outside the tensor cores
    b5 = bound(20 * R * S, nbytes(rgb, sigma, t, dnorm, *out_k), PEAK_F32)
    say("kernels", f"K5 volume render {R} rays × {S}: max abs err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in err.items()})} "
        f"(tol {K5_ATOL}, depth {K5_ATOL * far:g}); kernel on the device "
        f"{ms:.4f} ms (inputs warm {dev5['warm']:.4f}), a call of the "
        f"wrapper {call_ms:.3f} ms, plain {pms:.3f} ms; {bound_line(b5, ms)}"
        f"; yardstick: torch's device copy moves {rate / 1e12:.3f} TB/s, "
        f"K5's bytes at that rate {copy_ms:.4f} ms")
    if not (max(err["rgb"], err["acc"], err["weights"]) <= K5_ATOL
            and err["depth"] <= K5_ATOL * far):
        raise AssertionError("K5 disagrees with its plain version")
    return dict(max_abs_err=max(err.values()), ms=ms, wrapper_ms=call_ms,
                plain_ms=pms, **b5)


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
        with torch.no_grad(), routed(plain):
            return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                          occ=occ, device=device)

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
        "launches": all(launches[k] > 0 for k in ("field", "sigma_march",
                                                  "slim_march")),
        # K8: box_cull once, block_hit twice (proposal, fine) a live chunk
        "k8": (launches["box_cull"] == launches["sigma_march"]
               and launches["block_hit"] == 2 * launches["sigma_march"]),
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
    return launches, rgb


def phase_frame_generic(device, k2_rgb, gpu, smi):
    """The bench frame with `kernels.carry_hoist=false`: setup, then the
    frame through K1 + K6 (1 warm-up + 3 timed), then through the plain
    versions; against the plain frame and the K2 frame of phase 5."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.bench import bench_pose, setup
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    cfg = load_config("blender_lego", ["kernels.carry_hoist=false"])
    H = W = FRAME
    focal, c2w = bench_pose(W)
    K.reset_launches()
    params, occ, _ = setup(cfg, device)

    def render(plain=False):
        with torch.no_grad(), routed(plain):
            return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                          occ=occ, device=device)["rgb"]

    render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        rgb = render()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    launches = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    ref = render(plain=True)
    torch.cuda.synchronize()
    dt_plain = time.perf_counter() - t0
    p_plain = float(psnr(rgb, ref))
    p_k2 = float(psnr(rgb, k2_rgb))
    say("frame-generic", f"{H}x{W} with kernels.carry_hoist=false: "
        f"{dt:.4f} s/frame through K1 + K6 ({H * W / dt:.1f} rays/s), plain "
        f"versions {dt_plain:.4f} s; PSNR against the plain frame "
        f"{p_plain:.2f} dB, against the K2 frame {p_k2:.2f} dB (min "
        f"{FRAME_PSNR_MIN}); launches {launches}; {gpu} | {smi}")
    checks = {
        "launches": (launches["carry_march"] > 0
                     and launches["sigma_march"] > 0
                     and launches["slim_march"] == 0),
        "psnr_plain": p_plain >= FRAME_PSNR_MIN,
        "psnr_k2": p_k2 >= FRAME_PSNR_MIN,
        "shape_finite": (tuple(rgb.shape) == (H, W, 3)
                         and bool(torch.isfinite(rgb).all())),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"frame-generic checks failed: {failed}")
    return launches


def record_alive_fracs():
    """Wrap the two-stage march so that each call's alive_frac (the share
    of (tile, block) launches that ran, read from its flags) is kept: a
    live chunk marches its coarse pass (the proposal net, or the coarse
    net) and then its fine pass. → (list, undo)."""
    from fashion_nerf_torch.render import blockwise
    orig = blockwise.marched_pass
    fracs = []

    def recording(*a, **kw):
        out = orig(*a, **kw)
        fracs.append(out["alive_frac"])
        return out

    blockwise.marched_pass = recording
    return fracs, lambda: setattr(blockwise, "marched_pass", orig)


def mean_fracs(fracs) -> dict:
    """The mean alive_frac of the coarse and of the fine marches."""
    return {k: float(torch.stack(v).mean()) for k, v in
            (("coarse", fracs[0::2]), ("fine", fracs[1::2])) if v}


def frame_variant(device, overrides, phase):
    """The bench frame of blender_lego under `overrides`: setup (committed
    weights, occupancy through K3, proposal asset), 1 warm-up frame
    (recording the two-stage marches' alive_frac) and 3 timed through the
    kernels, then the frame through the plain versions → (rgb, plain rgb,
    seconds a frame, plain seconds, launches of the timed frames, mean
    alive_frac by march)."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.bench import bench_pose, setup
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    cfg = load_config("blender_lego", overrides)
    H = W = FRAME
    focal, c2w = bench_pose(W)
    params, occ, _ = setup(cfg, device)

    def render(plain=False):
        with torch.no_grad(), routed(plain):
            return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                          occ=occ, device=device)["rgb"]

    fracs, undo = record_alive_fracs()
    try:
        render()
    finally:
        undo()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    for _ in range(3):
        rgb = render()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    launches = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    ref = render(plain=True)
    torch.cuda.synchronize()
    dt_plain = time.perf_counter() - t0
    mean = mean_fracs(fracs)
    say(phase, f"alive_frac by march (mean over the live chunks of the "
        f"warm-up frame): {json.dumps(mean)}")
    return rgb, ref, dt, dt_plain, launches, mean


def phase_frame_twostage(device, k2_rgb, gpu, smi):
    """The bench frame with `kernels.fused_carry=false`: the two-stage
    march, one K3 launch with tile-skip flags a sample block, for the
    proposal net (a zero dirpart, K3 without a view branch) and the fine
    net; against its plain frame and the K2 frame of phase 5."""
    from fashion_nerf_torch.metrics import psnr
    rgb, ref, dt, dt_plain, launches, fracs = frame_variant(
        device, ["kernels.fused_carry=false"], "frame-twostage")
    p_plain, p_k2 = float(psnr(rgb, ref)), float(psnr(rgb, k2_rgb))
    say("frame-twostage", f"{FRAME}x{FRAME} with kernels.fused_carry=false: "
        f"{dt:.4f} s/frame through K3 with tile flags "
        f"({FRAME * FRAME / dt:.1f} rays/s), {launches['field_alive'] // 3} "
        f"K3 launches a frame; plain versions {dt_plain:.4f} s; PSNR against "
        f"the plain frame {p_plain:.2f} dB, against the K2 frame {p_k2:.2f} "
        f"dB (min {FRAME_PSNR_MIN}); launches {launches}; {gpu} | {smi}")
    checks = {
        "launches": (launches["field_alive"] > 0
                     and launches["sigma_march"] == 0
                     and launches["slim_march"] == 0),
        "fracs": set(fracs) == {"coarse", "fine"}
        and 0.0 < fracs["fine"] < 1.0,
        "psnr_plain": p_plain >= FRAME_PSNR_MIN,
        "psnr_k2": p_k2 >= FRAME_PSNR_MIN,
        "shape_finite": (tuple(rgb.shape) == (FRAME, FRAME, 3)
                         and bool(torch.isfinite(rgb).all())),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"frame-twostage checks failed: {failed}")
    return launches


def phase_frame_propmarch(device, k2_rgb, gpu, smi):
    """The bench frame with `proposal.sigma_march=false`: the generic
    proposal march, K2 on the σ-only net (no view branch) in place of K1;
    against its plain frame, and its PSNR against the K1 + K2 frame."""
    from fashion_nerf_torch.metrics import psnr
    rgb, ref, dt, dt_plain, launches, _ = frame_variant(
        device, ["proposal.sigma_march=false"], "frame-propmarch")
    p_plain, p_k1 = float(psnr(rgb, ref)), float(psnr(rgb, k2_rgb))
    say("frame-propmarch", f"{FRAME}x{FRAME} with proposal.sigma_march="
        f"false: {dt:.4f} s/frame through K2 without a view branch + K2 "
        f"({FRAME * FRAME / dt:.1f} rays/s), plain versions {dt_plain:.4f} "
        f"s; PSNR against the plain frame {p_plain:.2f} dB (min "
        f"{FRAME_PSNR_MIN}), against the K1 + K2 frame {p_k1:.2f} dB; "
        f"launches {launches}; {gpu} | {smi}")
    checks = {
        "launches": (launches["slim_march_novd"] > 0
                     and launches["slim_march"] > 0
                     and launches["sigma_march"] == 0),
        "psnr_plain": p_plain >= FRAME_PSNR_MIN,
        "shape_finite": (tuple(rgb.shape) == (FRAME, FRAME, 3)
                         and bool(torch.isfinite(rgb).all())),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"frame-propmarch checks failed: {failed}")
    return launches


def phase_frame_sb(device, k2_rgb, gpu, smi):
    """The bench frame under each of SB_FRAMES, marches at SBs outside
    16–64: against its plain frame and the K1 + K2 frame of phase 5
    (≥ FRAME_PSNR_MIN dB each), its "_sb" kernel launched in the timed
    frames. → launches summed over the frames."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.metrics import psnr
    total = {k: 0 for k in K.LAUNCHES}
    checks = {}
    for ovr, count in SB_FRAMES:
        rgb, ref, dt, dt_plain, launches, _ = frame_variant(
            device, list(ovr), "frame-sb")
        p_plain, p_k2 = float(psnr(rgb, ref)), float(psnr(rgb, k2_rgb))
        for k, v in launches.items():
            total[k] += v
        say("frame-sb", f"{FRAME}x{FRAME} with {' '.join(ovr)}: {dt:.4f} "
            f"s/frame ({FRAME * FRAME / dt:.1f} rays/s), plain versions "
            f"{dt_plain:.4f} s; PSNR against the plain frame {p_plain:.2f} "
            f"dB, against the K1 + K2 frame {p_k2:.2f} dB (min "
            f"{FRAME_PSNR_MIN}); launches "
            f"{ {k: v for k, v in launches.items() if v} }; {gpu} | {smi}")
        checks[" ".join(ovr)] = (
            launches[count] > 0 and p_plain >= FRAME_PSNR_MIN
            and p_k2 >= FRAME_PSNR_MIN
            and tuple(rgb.shape) == (FRAME, FRAME, 3)
            and bool(torch.isfinite(rgb).all()))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"frame-sb checks failed: {failed}")
    return total


def phase_sweep(device, gate_cache, gpu, smi):
    """The reference's spec sweep (`quality.run_sweep`) over every row at
    800×800 at the bench pose, through the kernels, scored against the
    gate's GT of that pose. Fails when a row raises or renders non-finite
    pixels, or when a proposal row's student dies (`distill_health`) but
    for SWEEP_SHARED_DEATH, whose verdict is printed. → launches of the
    whole sweep."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.quality import run_sweep
    t0 = time.perf_counter()
    gt, _ = gate_cache[(0, FRAME, FRAME)]
    K.reset_launches()
    res = run_sweep((), 0, device, FRAME, FRAME, gt=gt,
                    log=lambda m: say("sweep", m))
    launches = dict(K.LAUNCHES)
    bad = [r["name"] for r in res["rows"]
           if not (bool(torch.isfinite(r["image"]).all())
                   and tuple(r["image"].shape) == (FRAME, FRAME, 3))]
    dead = [r["name"] for r in res["rows"]
            if r["proposal"] is not None and r["proposal"]["dead"]]
    for name in dead:
        say("sweep", f"{name}: the distilled student is dead (σ > 0 on "
            "no box point, or its MSE within 1% of the teacher's mean "
            "square); "
            + ("the reference's step dies too from this init on the "
               "port's points (tests/test_torch_distill.py), so the row "
               "reports what it reads" if name == SWEEP_SHARED_DEATH else
               "no test shows the reference dying here"))
    say("sweep", f"{len(res['rows'])} rows in "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {gpu} | {smi}")
    # the same row distilled from other seeds (the default is 7)
    for seed in SWEEP_SEEDS:
        row = run_sweep((SWEEP_SHARED_DEATH,), 0, device, FRAME, FRAME,
                        gt=gt, log=lambda m: None, seed=seed)["rows"][-1]
        h = row["proposal"]
        say("sweep", f"{SWEEP_SHARED_DEATH} distilled from seed {seed}: σ > 0 "
            f"on {h['share']:.3f} of the box, MSE {h['mse']:.4f} (teacher's "
            f"mean square {h['teacher_ms']:.4f}){', DEAD' if h['dead'] else ''}"
            f"; delta-vs-dense {row['delta']:+.3f} dB; distilled in "
            f"{h['seconds']:.1f} s")
        bad += [] if bool(torch.isfinite(row["image"]).all()) else [seed]
    unexplained = [n for n in dead if n != SWEEP_SHARED_DEATH]
    if bad or unexplained or len(res["rows"]) != 40:
        raise AssertionError(f"sweep: non-finite rows {bad}, dead students "
                             f"{unexplained}")
    return launches


def phase_bench_train(device, step_s, gpu, smi):
    """`bench.bench_train` for blender_lego at the reference's recipe,
    beside [step]'s time of a step from the committed weights."""
    from fashion_nerf_torch.bench import bench_train
    from fashion_nerf_torch.config import load_config
    cfg = load_config("blender_lego")
    with torch.enable_grad():
        res = bench_train(cfg, device=device)
    say("bench-train", f"{json.dumps(res)}; [step]'s step "
        f"{step_s * 1e3:.1f} ms ({cfg.train.batch_rays / step_s:.1f} "
        f"rays/s); {gpu} | {smi}")
    if not (res["value"] > 0 and math.isfinite(res["step_ms"])
            and res["device"] == gpu):
        raise AssertionError(f"bench-train: {res}")
    return res


def phase_gate(device, gpu, smi):
    """`run_gate` at 800×800 over the 7 poses for the shipped preset (K1 +
    K2) and for `kernels.carry_hoist=false` (K1 + K6), scored against the
    same GT and dense renders: each pose's delta within GATE_BAND of the
    reference's, and the K6 image ≥ FRAME_PSNR_MIN dB against the K2 image
    at every pose. The −0.1 dB verdict is printed, not enforced here (the
    gate's own entry point exits 1 on FAIL)."""
    from fashion_nerf_torch import quality
    from fashion_nerf_torch.metrics import psnr
    cache, res = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for label, extra in (("K2", []), ("K6", ["kernels.carry_hoist=false"])):
        say("gate", f"production render through K1 + {label} "
            f"({extra or 'the shipped preset'})")
        res[label] = quality.run_gate(
            extra, device=device, cache=cache,
            log=lambda m: say("gate", m.strip("\n")))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("gate", f"{'pose':26s} {'ref delta':>9s} {'K2 delta':>9s} "
        f"{'K6 delta':>9s} {'K6 vs K2 dB':>11s}")
    bad = []
    for i, (a, b) in enumerate(zip(res["K2"]["rows"], res["K6"]["rows"])):
        p = float(psnr(b["image"], a["image"]))
        ref = REF_GATE_DELTAS[i]
        say("gate", f"{a['name']:26s} {ref:+9.3f} {a['delta']:+9.3f} "
            f"{b['delta']:+9.3f} {p:11.2f}")
        for label, r in (("K2", a), ("K6", b)):
            if abs(r["delta"] - ref) > GATE_BAND:
                bad.append(f"{label} {a['name']} delta {r['delta']:+.3f}")
        if p < FRAME_PSNR_MIN:
            bad.append(f"K6 vs K2 {a['name']} {p:.2f} dB")
    for label in ("K2", "K6"):
        r = res[label]
        say("gate", f"K1 + {label}: worst-pose delta {r['worst']:+.3f} dB "
            f"({r['worst_pose']}) — {'PASS' if r['ok'] else 'FAIL'} (gate "
            f"{quality.GATE_DB}); worst-pose throughput "
            f"{r['worst_mrays']:.3f} Mrays/s")
    say("gate", f"both gates in {secs:.1f} s; peak device memory "
        f"{peak:.2f} GiB; {gpu} | {smi}")
    if bad:
        raise AssertionError(f"gate checks failed: {bad}")
    return res, cache


# [branches]: the last blockwise branches on the bench frame, and the
# spec sweep's wider proposals distilled on the card (as its rows do)
BRANCH_DISTILL_STEPS = 1500
BRANCHES = (
    ("cov_n", ["proposal.cov_n=16"]),
    ("union", ["proposal.union=true"]),
    ("sample_warp", ["occupancy.sample_warp=true"]),
    ("prop 2×192 L8", ["proposal.net_width=192", "proposal.posenc_xyz=8",
                       f"proposal.distill_steps={BRANCH_DISTILL_STEPS}"]),
    ("prop 3×256 L8", ["proposal.net_width=256", "proposal.net_depth=3",
                       "proposal.posenc_xyz=8",
                       f"proposal.distill_steps={BRANCH_DISTILL_STEPS}"]),
    # the warp (samples and width caps) through the other two pipelines
    ("sample_warp K6", ["occupancy.sample_warp=true",
                        "kernels.carry_hoist=false"]),
    ("sample_warp two-stage", ["occupancy.sample_warp=true",
                               "kernels.fused_carry=false"]),
)


def branch_setup(cfg, device):
    """bench.setup's state for cfg (committed weights, occupancy through
    K3), with the committed proposal where it was distilled for cfg, else
    one distilled here on the card (proposal.distill_steps; the bench
    itself refuses to distil) → (params, occ, distillation seconds)."""
    from fashion_nerf_torch.bench import bench_params
    from fashion_nerf_torch.core.occupancy import build_from_config
    from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
    from fashion_nerf_torch.models.proposal import attach_proposal
    params, trained = bench_params(cfg, device)
    if not trained:
        raise AssertionError("the committed weights do not fit " + cfg.name)
    field = make_fused_field()
    occ = build_from_config(cfg, lambda p, v: field(params["fine"], p, v),
                            device=device)
    params = attach_proposal(cfg, params, allow_distill=False, device=device)
    secs = 0.0
    if "proposal" not in params:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            params = attach_proposal(cfg, params, occ=occ, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        distill_check(cfg, params, occ, field, device)
    return params, occ, secs


def distill_check(cfg, params, occ, field, device):
    """The distilled proposal on one batch of distillation points (8192,
    drawn as `distill_proposal` draws them, from seed 0): its log-density
    MSE against the teacher beside the teacher's own mean square (a student
    with σ ≤ 0 everywhere scores exactly that), the share of points with
    σ > 0, and the loss gradient through K3 + K4 against the same through
    the plain field (K4_REL_RMS on every parameter)."""
    from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
    from fashion_nerf_torch.models import proposal as prop_mod
    student = params["proposal"]
    gen = torch.Generator(device=device).manual_seed(0)

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).expand(3)
    pts = prop_mod.distill_points(gen, 8192, occ.box_min, occ.box_max,
                                  vec(cfg.occupancy.world_min),
                                  vec(cfg.occupancy.world_max))
    dirs = torch.tensor([0.0, 0.0, -1.0], device=device).expand(8192, 3)
    act = cfg.model.sigma_activation
    y = prop_mod.log_density(field(params["fine"], pts, dirs)[1][:, 0], act)
    sigma = field(student, pts, dirs)[1][:, 0]
    mse = float(((prop_mod.log_density(sigma, act) - y) ** 2).mean())
    grads = []
    for plain in (False, True):
        student.zero_grad(set_to_none=True)
        with torch.enable_grad(), routed(plain):
            prop_mod.distill_loss(student, pts, y, act, field).backward()
        grads.append([p.grad.detach().clone() for p in student.parameters()])
    student.zero_grad(set_to_none=True)
    rel = max(rel_rms(a, b) for a, b in zip(*grads))
    health = prop_mod.distill_health(
        cfg, lambda p, v: field(params["fine"], p, v), student, occ.box_min,
        occ.box_max)
    shared = (cfg.proposal.net_depth, cfg.proposal.net_width) == (3, 256)
    verdict = ("dead: σ > 0 on no box point, or MSE within 1% of the "
               "teacher's mean square; " + (
                   "the reference's step dies too from this seed-7 init on "
                   "the port's points (tests/test_torch_distill.py), so the "
                   "frame reports what it reads" if shared else
                   "no test shows the reference dying here")
               if health["dead"] else "alive")
    say("branches", f"distilled {cfg.proposal.net_depth}×"
        f"{cfg.proposal.net_width} proposal on 8192 box points: σ > 0 on "
        f"{health['share']:.3f}, MSE {health['mse']:.4f} (the teacher's "
        f"mean square {health['teacher_ms']:.4f}); verdict: {verdict}")
    if health["dead"] and not shared:
        raise AssertionError("a distilled proposal died")
    say("branches", f"distilled {cfg.proposal.net_depth}×"
        f"{cfg.proposal.net_width} proposal on 8192 distillation points: "
        f"log-density MSE {mse:.4f} (the teacher's mean square "
        f"{float((y ** 2).mean()):.4f}), σ > 0 on "
        f"{float((sigma > 0).float().mean()):.3f} of them; the loss "
        f"gradient through K3 + K4 against the plain field: relative RMS "
        f"{rel:.3g} at most (tol {K4_REL_RMS})")
    if not rel <= K4_REL_RMS:
        raise AssertionError("the distillation's gradient through K3 + K4 "
                             "disagrees with the plain field's")


def phase_branches(device, gate, gate_cache, gpu, smi):
    """The blender_lego bench frame under each of BRANCHES: 1 warm-up and
    3 timed frames through the kernels (launches of the timed frames),
    then the frame through the plain versions (≥ FRAME_PSNR_MIN dB); the
    frame's PSNR against the analytic GT minus the dense 64+128 frame's
    (the gate's references at the bench pose) beside the shipped preset's;
    the warp through K6 and the two-stage march also against the K1 + K2
    warp frame (≥ FRAME_PSNR_MIN dB). → launches summed over the frames."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.bench import bench_pose
    from fashion_nerf_torch.kernels.sigmamarch import sigma_kernel
    from fashion_nerf_torch.kernels.posenc_mlp import pack_params
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.render.blockwise import (fine_march_samples,
                                                     render_image_blockwise)
    t_phase = time.perf_counter()
    H = W = FRAME
    focal, c2w = bench_pose(W)
    gt, dense = gate_cache[(0, H, W)]
    d_gt = float(psnr(dense, gt))
    base = gate["K2"]["rows"][0]
    total = {k: 0 for k in K.LAUNCHES}
    frames, checks = {}, {}
    for label, ovr in BRANCHES:
        cfg = load_config("blender_lego", ovr)
        params, occ, distill_s = branch_setup(cfg, device)

        def render(plain=False):
            with torch.no_grad(), routed(plain):
                return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                              occ=occ, device=device)["rgb"]

        render()
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(3):
            rgb = render()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        for k, v in K.LAUNCHES.items():
            total[k] += v
        ref = render(plain=True)
        torch.cuda.synchronize()
        p_plain = float(psnr(rgb, ref))
        delta = float(psnr(rgb, gt)) - d_gt
        frames[label] = rgb
        prop = cfg.proposal
        served = sigma_kernel(pack_params(params["proposal"], hoist_x=True))
        n_f = fine_march_samples(cfg, occ)
        SB = cfg.kernels.block_samples
        extra = ""
        if label in ("sample_warp K6", "sample_warp two-stage"):
            p_k2 = float(psnr(rgb, frames["sample_warp"]))
            extra = f", against the K1 + K2 warp frame {p_k2:.2f} dB"
            checks[f"{label} vs K2"] = p_k2 >= FRAME_PSNR_MIN
        say("branches", f"{label} ({' '.join(ovr)}): {dt:.4f} s/frame "
            f"({H * W / dt:.1f} rays/s), mean of 3 after 1 warm-up; proposal "
            f"{prop.net_depth}×{prop.net_width} L = {prop.posenc_xyz}"
            f"{f' distilled in {distill_s:.1f} s' if distill_s else ''}, its "
            f"σ march on {served if cfg.kernels.fused_carry else 'K3'}; fine "
            f"march {n_f} samples a ray, {-(-n_f // SB)} blocks of {SB}; "
            f"PSNR against the plain frame {p_plain:.2f} dB (min "
            f"{FRAME_PSNR_MIN}){extra}; against the analytic GT minus the "
            f"dense 64+128 frame's: {delta:+.3f} dB (the shipped preset's "
            f"{base['delta']:+.3f}); launches of the 3 frames {launches}; "
            f"{gpu} | {smi}")
        # K8 culls every branch (the warp bins its segments materialised)
        want = {"cov_n": ("sigma_march", "slim_march"),
                "union": ("sigma_march", "slim_march"),
                "sample_warp": ("sigma_march", "slim_march"),
                "prop 2×192 L8": ("sigma_march_k2", "slim_march"),
                "prop 3×256 L8": ("sigma_march_k2", "slim_march"),
                "sample_warp K6": ("sigma_march", "carry_march"),
                "sample_warp two-stage": ("field_alive",)}[label]
        want += K8_ENTRIES
        checks[label] = (p_plain >= FRAME_PSNR_MIN
                         and set(launches) == set(want)
                         and bool(torch.isfinite(rgb).all())
                         and tuple(rgb.shape) == (H, W, 3))
        del params, occ, ref
        torch.cuda.empty_cache()
    say("branches", f"checks {checks}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"branches checks failed: {failed}")
    return total


def phase_probe(device, gpu, smi):
    """The probe's main path: P1's variants and P2's sweep, as `python -m
    fashion_nerf_torch.probe [--shapes]` runs them."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch import probe
    K.reset_launches()
    rows = (probe.run_p1(device, log=lambda m: say("probe", "P1 " + m))
            + probe.run_p2(device, log=lambda m: say("probe", "P2 " + m)))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    # yardsticks, which the port never calls: one torch.matmul at the field
    # layer's shape, and P1's chain+relu as ten torch.matmul calls with the
    # relu and the bf16 cast between (bf16 in, f32 out of the last)
    x, ws = probe.make_inputs(probe.P1_ROWS, probe.P1_WIDTH, probe.P1_DEPTH,
                              0.06, 0, device)
    ms = cuda_ms(lambda: torch.matmul(x, ws[0]))
    flop = 2 * probe.P1_ROWS * probe.P1_WIDTH ** 2
    say("probe", f"yardstick torch.matmul ({probe.P1_ROWS}×256)·(256×256) "
        f"bf16: {ms:.3f} ms, {flop / ms / 1e9:.1f} TFLOP/s")
    try:    # whether this torch's mm writes f32 from bf16 operands
        torch.mm(x[:64], ws[0], out_dtype=torch.float32)
        last = lambda h: torch.mm(h, ws[0], out_dtype=torch.float32)  # noqa
        how = "f32 written by the last product"
    except TypeError:
        last = lambda h: torch.mm(h, ws[0]).float()  # noqa: E731
        how = "the last product's bf16 output cast to f32"

    def chain10():
        h = x
        for w in ws:
            h = torch.relu(torch.mm(h, w))
        return last(h)

    ms10 = cuda_ms(chain10)
    say("probe", f"yardstick chain+relu as ten torch.matmul calls ({how}): "
        f"{ms10:.3f} ms, {flop * (probe.P1_DEPTH + 1) / ms10 / 1e9:.1f} "
        f"TFLOP/s (a composition of calls, not one call)")
    del x, ws
    say("probe", f"launches {launches}; {gpu} | {smi}")
    if not (launches["probe_p1"] > 0 and launches["probe_p2"] > 0
            and all(math.isfinite(r["tflops"]) and r["tflops"] > 0
                    for r in rows)):
        raise AssertionError("probe checks failed")
    return launches


def committed_state(cfg, device):
    """A TrainState holding the committed trained coarse and fine nets."""
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.train.state import TrainState, make_optimizer
    trained, meta = load_flagship()
    nets = {k: load_flax_params(trained[k],
                                compute_dtype=cfg.model.compute_dtype,
                                device=device) for k in ("coarse", "fine")}
    params = [p for n in nets.values() for p in n.parameters()]
    return TrainState(step=0, coarse=nets["coarse"], fine=nets["fine"],
                      optimizer=make_optimizer(cfg, params),
                      generator=torch.Generator(device=device).manual_seed(
                          0)), meta


def phase_scene(cfg, device):
    """The hermetic training scene that `train` builds when data.root is
    empty (the scene the committed weights were trained on)."""
    from fashion_nerf_torch.data.pipeline import ray_dataset
    from fashion_nerf_torch.train.loop import load_dataset
    t0 = time.perf_counter()
    scene = load_dataset(cfg)
    secs = time.perf_counter() - t0
    ds = ray_dataset(cfg, scene["images"], scene["poses"], scene["focal"],
                     device=device)
    ds.val_image, ds.val_pose = scene["val_image"], scene["val_pose"]
    say("scene", f"{ds.N} views of {ds.H}x{ds.W} and a val view rendered "
        f"in {secs:.1f} s (numpy, host); {ds.n_rays} rays on the card")
    return scene, ds


def phase_step(device, ds, gpu, smi):
    """One training step from the committed weights, kernels (K3 + K4)
    against the plain versions: same batch, no jitter, same sparsity
    points. The fine samples come from an inverse CDF of the coarse
    weights, so last-bit differences of the coarse pass move them, and the
    first fine layer, which sees posenc frequencies up to 2^9, turns that
    into ~1% of its gradient. So the plain step runs twice: with its own
    fine samples (gradients held to STEP_GRAD_SAMPLES_REL) and with the
    kernel step's (gradients held to STEP_GRAD_REL). Then the time of full
    steps (Adam included) of both."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.render import renderer
    from fashion_nerf_torch.train.loop import TrainStep, sparsity_points
    cfg = load_config("blender_lego", ["sampling.perturb=false"])
    idx = torch.from_numpy(np.random.default_rng(1).choice(
        ds.n_rays, cfg.train.batch_rays, replace=False)).to(device)
    batch = {k: v[idx] for k, v in ds.batch_arrays().items()}
    pts = sparsity_points(cfg, torch.Generator(device=device).manual_seed(2),
                          device)
    sample_pdf = renderer.sample_pdf
    fine_t = []

    def loss_and_grads(plain, replay):
        """(loss, gradients); the kernel run records its fine samples,
        replay=True makes this run reuse them."""
        def sampler(*a, **kw):
            if replay:
                return fine_t[0]
            fine_t.append(sample_pdf(*a, **kw))
            return fine_t[-1]

        state, _ = committed_state(cfg, device)
        step = TrainStep(cfg, ds, streamed=True)
        renderer.sample_pdf = sampler
        try:
            with torch.enable_grad(), routed(plain):
                loss, _ = step.loss(state, batch, sparsity_pts=pts)
                loss.backward()
        finally:
            renderer.sample_pdf = sample_pdf
        return float(loss), {f"{k}.{n}": p.grad for k, net in
                             state.nets().items()
                             for n, p in net.named_parameters()}

    loss_k, grads_k = loss_and_grads(False, False)
    checks, report = {}, []
    for label, replay, tol in (("own fine samples", False,
                                STEP_GRAD_SAMPLES_REL),
                               ("the kernel step's fine samples", True,
                                STEP_GRAD_REL)):
        loss_p, grads_p = loss_and_grads(True, replay)
        e_loss = abs(loss_k - loss_p) / abs(loss_p)
        rel = {k: rel_rms(grads_k[k], grads_p[k]) for k in grads_p}
        worst = max(rel, key=rel.get)
        report.append(f"plain step with {label}: loss {loss_p:.7g} (rel "
                      f"{e_loss:.3g}, tol {STEP_LOSS_REL}), worst gradient "
                      f"relative RMS {rel[worst]:.3g} ({worst}, tol {tol}) "
                      f"over {len(rel)} parameters")
        checks[label] = e_loss <= STEP_LOSS_REL and rel[worst] <= tol
    secs = {}
    for plain in (False, True):
        state, _ = committed_state(cfg, device)
        step = TrainStep(cfg, ds, streamed=True)
        with torch.enable_grad(), routed(plain):
            step(state, batch, sparsity_pts=pts)          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step(state, batch, sparsity_pts=pts)
            torch.cuda.synchronize()
        secs[plain] = (time.perf_counter() - t0) / 3
    say("step", f"loss through the kernels {loss_k:.7g}; "
        + "; ".join(report) + f"; step {secs[False] * 1e3:.1f} ms through "
        f"the kernels ({cfg.train.batch_rays / secs[False]:.1f} rays/s), "
        f"{secs[True] * 1e3:.1f} ms plain (mean of 3); {gpu} | {smi}")
    if not (all(checks.values()) and math.isfinite(loss_k)):
        raise AssertionError(f"the kernel step disagrees with the plain step:"
                             f" {checks}")
    return dict(step_s=secs[False], plain_step_s=secs[True])


def phase_eval(device, ds):
    """The trainer's evaluation of the held-out view from the committed
    weights, through K3 + K5 and through the plain versions."""
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.train.loop import evaluate
    cfg = load_config("blender_lego")
    state, meta = committed_state(cfg, device)
    ref = float(meta["val_psnr"])
    out, times = {}, {}
    for plain in (False, True):
        t0 = time.perf_counter()
        with routed(plain):
            out[plain] = evaluate(cfg, state, ds)
        torch.cuda.synchronize()
        times[plain] = time.perf_counter() - t0
    (img_k, p_k), (img_p, p_p) = out[False], out[True]
    p_kp = float(psnr(img_k["rgb"], img_p["rgb"]))
    say("eval", f"val PSNR through the kernels {p_k:.4f} dB, plain "
        f"{p_p:.4f} dB, the reference's {ref:.4f} dB (tol {EVAL_PSNR_TOL});"
        f" kernel image against plain image {p_kp:.2f} dB; "
        f"{times[False]:.3f} s and {times[True]:.3f} s")
    ok = (abs(p_k - ref) <= EVAL_PSNR_TOL and abs(p_p - ref) <= EVAL_PSNR_TOL
          and abs(ref - EVAL_PSNR) < 1e-3 and p_kp >= FRAME_PSNR_MIN
          and tuple(img_k["rgb"].shape) == (ds.H, ds.W, 3)
          and bool(torch.isfinite(img_k["rgb"]).all()))
    if not ok:
        raise AssertionError("eval checks failed")
    return dict(val_psnr=p_k, plain_val_psnr=p_p)


def phase_train(scene, device, gpu, smi):
    """`train()` at blender_lego's full width from random init: a refresh
    at step 4, culled steps, dense steps (the first four and every 8th),
    one eval and one checkpoint at step 24."""
    import shutil
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.train.loop import train
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    cfg = load_config("blender_lego", [
        "train.iters=24", "train.log_every=4", "train.occ_warmup=4",
        "train.occ_refresh_every=1000", "train.occ_dense_every=8",
        "train.eval_every=24", "train.ckpt_every=24", f"out_dir={RUN_DIR}"])
    K.reset_launches()
    t0 = time.perf_counter()
    with torch.enable_grad():
        state, hist = train(cfg, dataset_dict=scene, device=device,
                            log_fn=lambda e: say("train", json.dumps(e)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    logs = [h for h in hist if "loss" in h]
    rate = statistics.median(h["rays_per_sec"] for h in logs[1:])
    evals = [h["val_psnr"] for h in hist if "val_psnr" in h]
    saved = ckpt_lib.steps(os.path.join(RUN_DIR, cfg.name, "ckpt"))
    last = logs[-1]
    say("train", f"{state.step} steps in {secs:.2f} s; loss {logs[0]['loss']:.5f}"
        f" at step {logs[0]['step']} → {last['loss']:.5f} at step "
        f"{last['step']} (both dense); refreshes {last['refreshes']}, culled "
        f"steps {last['culled_steps']}, dense steps {last['dense_steps']}; "
        f"eval {evals}; checkpoints {saved}; {rate:.1f} rays/s "
        f"({rate / cfg.train.batch_rays:.3f} steps/s, median of the log "
        f"windows after the first); launches {launches}; {gpu} | {smi}")
    checks = {
        "finite": all(math.isfinite(h["loss"]) for h in logs),
        "falls": last["loss"] < logs[0]["loss"],
        "kinds": (last["refreshes"] >= 1 and last["culled_steps"] >= 1
                  and last["dense_steps"] >= 1),
        "eval": len(evals) == 1 and math.isfinite(evals[0]),
        "ckpt": saved == [24],
        "launches": all(launches[k] > 0
                        for k in ("field", "field_bwd", "volrend")),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    return launches, dict(rays_per_sec=rate, seconds=secs)


def phase_train_small(scene, device, gpu, smi):
    """`train()` of a net below the field kernels' widths (3×32, L = 4)
    with `kernels.use_pallas=true`: the fields run K3 and K4 on the
    zero-padded net, through dense steps, a refresh, culled steps and an
    eval."""
    import shutil
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.train.loop import train
    run_dir = RUN_DIR + "_small"
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = load_config("blender_lego", [
        "model.net_depth=3", "model.net_width=32", "model.posenc_xyz=4",
        "kernels.use_pallas=true", "train.iters=12", "train.log_every=2",
        "train.occ_warmup=4", "train.occ_refresh_every=1000",
        "train.occ_dense_every=4", "train.eval_every=12",
        "train.ckpt_every=1000000", f"out_dir={run_dir}"])
    K.reset_launches()
    t0 = time.perf_counter()
    with torch.enable_grad():
        state, hist = train(cfg, dataset_dict=scene, device=device,
                            log_fn=lambda e: None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    logs = [h for h in hist if "loss" in h]
    evals = [h["val_psnr"] for h in hist if "val_psnr" in h]
    last = logs[-1]
    say("train-small", f"{state.step} steps of a {cfg.model.net_depth}×"
        f"{cfg.model.net_width} net (L = {cfg.model.posenc_xyz}) in "
        f"{secs:.2f} s; loss {logs[0]['loss']:.5f} at step "
        f"{logs[0]['step']} → {last['loss']:.5f} at step {last['step']}; "
        f"refreshes {last['refreshes']}, culled steps "
        f"{last['culled_steps']}, dense steps {last['dense_steps']}; eval "
        f"{evals}; launches {launches}; {gpu} | {smi}")
    checks = {
        "finite": all(math.isfinite(h["loss"]) for h in logs),
        "kinds": (last["refreshes"] >= 1 and last["culled_steps"] >= 1
                  and last["dense_steps"] >= 1),
        "eval": len(evals) == 1 and math.isfinite(evals[0]),
        "launches": launches["field"] > 0 and launches["field_bwd"] > 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train-small checks failed: {failed}")
    return launches


def cli_call(argv, dataset=None, phase="cli"):
    """cli.main(argv) with stdout and stderr captured (stderr echoed under
    `phase`) → (exit code, stdout lines, stderr, seconds, launches, the
    frames an eval rendered). The launch counters are reset first."""
    import contextlib
    import io
    from fashion_nerf_torch import cli
    from fashion_nerf_torch import kernels as K
    out, err, frames = io.StringIO(), io.StringIO(), []
    eval_views = cli.eval_views

    def recording(*a, **kw):
        scores, imgs = eval_views(*a, **kw)
        frames.extend(imgs)
        return scores, imgs

    K.reset_launches()
    t0 = time.perf_counter()
    cli.eval_views = recording
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv, dataset=dataset)
    finally:
        cli.eval_views = eval_views
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        say(phase, f"{argv[0]} stderr: {line}")
    return (rc, out.getvalue().strip().splitlines(), err.getvalue(), secs,
            dict(K.LAUNCHES), frames)


def phase_cli(scene, device, gpu, smi):
    """`python -m fashion_nerf_torch` at blender_lego's full width from a
    checkpoint of the committed flagship weights, every subcommand through
    `cli.main` on the hermetic training scene:

    - `eval` through the kernels (occupancy through K3, the asset's
      proposal, the frame through K1 + K2) and with
      `kernels.use_pallas=false` (the dense renderer, plain torch): PSNRs
      within CLI_PSNR_TOL of each other and of the reference's, the frames
      ≥ FRAME_PSNR_MIN dB apart;
    - `render` over the scene's poses: the PNGs decode to the frames;
    - `train --resume` for two steps at a vanishing learning rate, so that
      the asset's signature no longer matches, then `eval`: a proposal is
      distilled on the card (DISTILL_STEPS steps), and its frame is held
      against the asset's;
    - `bench`, and `parity` on a root without scenes (exit code 1)."""
    import re
    import shutil
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch import cli, png
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.metrics import psnr
    run = RUN_DIR + "_cli"
    shutil.rmtree(run, ignore_errors=True)
    base = ["--config", "blender_lego", "--out", run]
    cfg = load_config("blender_lego", [f"out_dir={run}"])
    state, _ = committed_state(cfg, device)
    ckpt_dir = os.path.join(run, cfg.name, "ckpt")
    ckpt_lib.save(ckpt_dir, state)
    del state

    def call(cmd, *overrides, flags=()):
        return cli_call([cmd] + base + list(flags)
                        + [x for kv in overrides for x in ("--set", kv)],
                        scene)

    checks = {}
    # eval: the kernels, then the plain dense renderer
    rc, out, _, secs_k, launches, (img_k,) = call("eval")
    row_k = json.loads(out[-1])
    rc_p, out, _, secs_p, launches_p, (img_p,) = call(
        "eval", "kernels.use_pallas=false")
    row_p = json.loads(out[-1])
    p_kp = float(psnr(img_k, img_p))
    say("cli", f"eval from {ckpt_dir}: {json.dumps(row_k)} in {secs_k:.3f} s "
        f"through the kernels, launches {launches}; {json.dumps(row_p)} in "
        f"{secs_p:.3f} s with kernels.use_pallas=false (dense, plain), "
        f"launches {sum(launches_p.values())}; frames {p_kp:.2f} dB apart "
        f"(min {FRAME_PSNR_MIN}); the reference's {EVAL_PSNR:.4f} dB")
    checks["eval"] = (
        rc == 0 and rc_p == 0 and row_k["n_views"] == 1
        and sorted(row_k) == ["n_views", "psnr", "ssim"]
        and abs(row_k["psnr"] - row_p["psnr"]) <= CLI_PSNR_TOL
        and abs(row_p["psnr"] - EVAL_PSNR) <= EVAL_PSNR_TOL
        and 0.9 < row_k["ssim"] <= 1.0 and p_kp >= FRAME_PSNR_MIN
        and all(launches[k] > 0 for k in ("field", "sigma_march",
                                          "slim_march"))
        and not any(launches_p.values()))

    # render: the scene's poses → PNGs
    rc, out, err, secs, launches, _ = call("render")
    row = json.loads(out[-1])
    files = sorted(f for f in os.listdir(row["out"]) if f.endswith(".png"))
    n = len(scene["poses"])
    _, render_fn, _, _ = cli._setup(cfg, device, scene)
    worst, stds = 0, []
    for i in (0, n - 1):
        got = png.read_png(os.path.join(row["out"], f"{i:03d}.png"))
        with torch.no_grad():
            want = render_fn(scene["poses"][i])["rgb"].clamp(0, 1)
        want = (want * 255).to(torch.uint8).cpu().numpy()
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
        stds.append(float(got.std()))
    say("cli", f"render: {row['frames']} frames in {secs:.3f} s, "
        f"{len(files)} PNGs in {row['out']}; first and last decode to the "
        f"frames within {worst} of 255 levels, pixel std {stds}; launches "
        f"{launches}")
    checks["render"] = (rc == 0 and row["frames"] == n == len(files)
                        and worst <= 1 and min(stds) > 1.0
                        and "seconds a frame min" in err
                        and launches["slim_march"] > 0)

    # two steps at a vanishing learning rate move the weights off the
    # asset's signature; eval then distils a proposal for them
    rc, out, _, secs, _, _ = call(
        "train", "train.iters=2", "train.lr_init=1e-7", "train.lr_final=1e-8",
        "train.log_every=2", "train.ckpt_every=2", "train.eval_every=1000",
        flags=["--resume"])
    checks["resume"] = rc == 0 and ckpt_lib.steps(ckpt_dir) == [0, 2]
    rc, out, err, secs_d, launches, (img_d,) = call(
        "eval", f"proposal.distill_steps={DISTILL_STEPS}")
    row_d = json.loads(out[-1])
    m = re.search(r"distilled in (\d+) steps \(([\d.]+) s on cuda\), final "
                  r"log-density MSE ([\d.eE+-]+)", err)
    if m is None:
        raise AssertionError(f"no distillation line on stderr: {err!r}")
    p_da = float(psnr(img_d, img_k))
    say("cli", f"eval after 2 steps at lr 1e-7 (checkpoints "
        f"{ckpt_lib.steps(ckpt_dir)}): the asset no longer matches; proposal "
        f"distilled on the card in {m.group(1)} steps, {m.group(2)} s, final "
        f"log-density MSE {m.group(3)}; {json.dumps(row_d)} in {secs_d:.3f} "
        f"s; its frame against the asset's frame {p_da:.2f} dB (min "
        f"{FRAME_PSNR_MIN}); launches {launches}")
    checks["distilled"] = (
        rc == 0 and int(m.group(1)) == DISTILL_STEPS
        and math.isfinite(float(m.group(3))) and p_da >= FRAME_PSNR_MIN
        and abs(row_d["psnr"] - row_k["psnr"]) <= CLI_PSNR_TOL
        and launches["sigma_march"] > 0)

    rc, out, _, secs, launches, _ = call("bench")
    bench = json.loads(out[-1])
    say("cli", f"bench in {secs:.3f} s: {json.dumps(bench)}")
    checks["bench"] = (rc == 0 and bench["value"] > 0 and bench["proposal"]
                       and bench["launches_per_frame"]["slim_march"] > 0)

    empty = os.path.join(run, "no_scenes")
    os.makedirs(empty, exist_ok=True)
    rc, out, err, _, _, _ = call("parity", f"data.root={empty}")
    say("cli", f"parity on a root without scenes: exit code {rc}")
    checks["parity"] = (rc == 1 and not out
                        and json.loads(err)["error"] == "no scenes found")
    say("cli", f"checks {checks}; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"cli checks failed: {failed}")


def write_llff_scene(root, H, W, n, seed):
    """A tiny LLFF scene in the poses_bounds.npy layout: n seeded random
    images (PNGs through the port's writer) and cameras in [down, right,
    back] spread along x and y, looking down −z."""
    from fashion_nerf_torch.png import write_png
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows = []
    for i in range(n):
        write_png(os.path.join(root, "images", f"{i:03d}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        c2w = np.zeros((3, 5), np.float32)
        c2w[:, 0], c2w[:, 1], c2w[:, 2] = [0, -1, 0], [1, 0, 0], [0, 0, 1]
        c2w[:, 3] = [0.1 * i, 0.02 * i, 0.0]
        c2w[:, 4] = [H, W, 1.2 * W]
        rows.append(np.concatenate([c2w.reshape(-1), [2.0 + 0.1 * i, 10.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))


def phase_llff(device, gpu, smi):
    """`llff_fern` at full width (8×256, L = 10, 64 + 128 samples, NDC,
    σ noise 1.0 in training, no occupancy, no proposal, the two-stage
    march) through `cli.main`, on the hermetic forward scene (12 views of
    96×128, `load_dataset`'s fallback):

    - `train` for LLFF_STEPS steps of 4096 rays (K3 + K4 + K5): the loss
      falls;
    - `eval` through the two-stage kernels (K3 with tile flags) and with
      `kernels.use_pallas=false` (dense, plain): within CLI_PSNR_TOL;
    - `render` of the 40-view spiral of a tiny LLFF fixture (data.root):
      the PNGs read back;
    - `bench` at 800×800 from random init, as the reference benches it:
      20 chunks × (2 + 6) K3 launches of 1,048,576 rows; one live chunk of
      its frame held against the plain version (≥ FRAME_PSNR_MIN dB);
    - a frame at 378×504, fern's factor-8 size (scanline ray order),
      through the kernels and plain (≥ FRAME_PSNR_MIN dB);
    - `parity` over a root of two tiny LLFF scenes, each with a copy of
      the trained checkpoint."""
    import shutil
    from fashion_nerf_torch import cli, png
    from fashion_nerf_torch.bench import bench_params, bench_pose
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.core.cameras import generate_rays, ndc_rays
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.render.blockwise import (_tile_order,
                                                     render_image_blockwise,
                                                     render_rays_blockwise)
    from fashion_nerf_torch.train.loop import load_dataset
    run = RUN_DIR + "_llff"
    shutil.rmtree(run, ignore_errors=True)
    cfg = load_config("llff_fern", [f"out_dir={run}"])
    t0 = time.perf_counter()
    scene = load_dataset(cfg)
    say("llff", f"hermetic forward scene: {len(scene['images'])} views of "
        f"{scene['H']}x{scene['W']} in {time.perf_counter() - t0:.1f} s "
        "(numpy, host)")
    base = ["--config", "llff_fern", "--out", run]

    def call(cmd, *overrides, dataset=scene, out=None):
        argv = [cmd] + (base if out is None else ["--config", "llff_fern",
                                                  "--out", out])
        return cli_call(argv + [x for kv in overrides
                                for x in ("--set", kv)], dataset)

    checks = {}
    rc, out, _, secs, launches, _ = call(
        "train", f"train.iters={LLFF_STEPS}", "train.log_every=4",
        f"train.eval_every={LLFF_STEPS}", f"train.ckpt_every={LLFF_STEPS}")
    entries = [json.loads(x.split(" ", 1)[1]) for x in out
               if x.startswith("[fashion-nerf-torch] {")]
    logs = [h for h in entries if "loss" in h]
    val = [h["val_psnr"] for h in entries if "val_psnr" in h]
    rate = statistics.median(h["rays_per_sec"] for h in logs[1:])
    say("llff", f"train: {LLFF_STEPS} steps of {cfg.train.batch_rays} rays "
        f"in {secs:.2f} s; loss {[round(h['loss'], 5) for h in logs]}; "
        f"{rate:.1f} rays/s (median of the log windows after the first); "
        f"val PSNR {val} (the trainer's eval, K3 + K5); launches "
        f"{launches}; {gpu} | {smi}")
    checks["train"] = (rc == 0 and len(logs) == LLFF_STEPS // 4
                       and len(val) == 1 and math.isfinite(val[0])
                       and all(math.isfinite(h["loss"]) for h in logs)
                       and logs[-1]["loss"] < logs[0]["loss"]
                       and all(launches[k] > 0 for k in
                               ("field", "field_bwd", "volrend")))

    rc, out, _, secs_k, launches_k, (img_k,) = call("eval")
    row_k = json.loads(out[-1])
    rc_p, out, _, secs_p, launches_p, (img_p,) = call(
        "eval", "kernels.use_pallas=false")
    row_p = json.loads(out[-1])
    p_kp = float(psnr(img_k, img_p))
    say("llff", f"eval: {json.dumps(row_k)} in {secs_k:.3f} s through the "
        f"two-stage kernels, launches {launches_k}; {json.dumps(row_p)} in "
        f"{secs_p:.3f} s with kernels.use_pallas=false; frames {p_kp:.2f} "
        "dB apart")
    checks["eval"] = (rc == 0 and rc_p == 0
                      and abs(row_k["psnr"] - row_p["psnr"]) <= CLI_PSNR_TOL
                      and launches_k["field_alive"] > 0
                      and not any(launches_p.values()))

    root = os.path.join(run, "scenes")
    for i, name in enumerate(("fern", "orchids")):
        write_llff_scene(os.path.join(root, name), 24, 32, 6, i)
    rc, out, err, secs, launches, _ = call(
        "render", f"data.root={os.path.join(root, 'fern')}",
        "data.llff_factor=1", dataset=None)
    row = json.loads(out[-1])
    files = sorted(f for f in os.listdir(row["out"]) if f.endswith(".png"))
    imgs = [png.read_png(os.path.join(row["out"], f)) for f in files]
    say("llff", f"render of the fixture's spiral: {row['frames']} frames in "
        f"{secs:.3f} s, {len(files)} PNGs of {imgs[0].shape}, pixel std "
        f"{float(np.std(imgs[0])):.2f}; launches {launches}")
    checks["render"] = (rc == 0 and row["frames"] == 40 == len(files)
                        and all(x.shape == (24, 32, 3) for x in imgs)
                        and float(np.std(imgs[0])) > 0
                        and launches["field_alive"] > 0)

    rc, out, _, secs, launches, _ = call("bench", dataset=None)
    bench = json.loads(out[-1])
    per_frame = bench["launches_per_frame"]
    say("llff", f"bench in {secs:.3f} s: {json.dumps(bench)}")
    checks["bench"] = (rc == 0 and bench["value"] > 0
                       and not bench["trained_ckpt"]
                       and not bench["occupancy_cull"]
                       and not bench["proposal"]
                       and per_frame["field_alive"] == 20 * (2 + 6)
                       and per_frame["field"] == 0)
    llff_launches = {k: int(v * 3) for k, v in per_frame.items()}

    # one live chunk of the bench frame, kernels against plain
    H = W = FRAME
    focal, c2w = bench_pose(W)
    nets, _ = bench_params(cfg, device)
    o, dd = generate_rays(H, W, focal, c2w, device=device)
    o, dd = o.reshape(-1, 3), dd.reshape(-1, 3)
    v = dd
    o, dd = ndc_rays(H, W, focal, 1.0, o, dd)
    order = torch.from_numpy(_tile_order(H, W)[0]).to(device)
    c = H * W // cfg.render.chunk // 2          # a middle chunk: live
    sl = slice(c * cfg.render.chunk, (c + 1) * cfg.render.chunk)
    o, dd, v = (x[order][sl].contiguous() for x in (o, dd, v))

    def chunk(plain):
        with torch.no_grad(), routed(plain):
            return render_rays_blockwise(nets, cfg, o, dd,
                                         v)["fine"]["rgb"]

    rgb_c = chunk(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_c = chunk(True)
    torch.cuda.synchronize()
    secs_c = time.perf_counter() - t0
    p_chunk = float(psnr(rgb_c, ref_c))
    say("llff", f"bench chunk {c} ({cfg.render.chunk} rays, NDC, random "
        f"init): PSNR kernels against plain {p_chunk:.2f} dB (min "
        f"{FRAME_PSNR_MIN}); the plain chunk {secs_c:.3f} s")
    checks["chunk"] = p_chunk >= FRAME_PSNR_MIN

    # where the bench frame's time goes: device time by kernel
    # (torch.profiler, device events) against the frame's host clock
    from torch.profiler import ProfilerActivity, profile

    def frame():
        with torch.no_grad():
            render_image_blockwise(nets, cfg, H, W, focal, c2w,
                                   device=device)
        torch.cuda.synchronize()

    frame()
    t0 = time.perf_counter()
    frame()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        frame()
    per = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()}
    busy = sum(per.values())
    k3 = sum(v for k, v in per.items() if "field_kernel" in k)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    say("llff", f"bench frame profile: {wall * 1e3:.1f} ms a frame, device "
        f"{busy:.1f} ms (busy {busy / (wall * 1e3):.3f}), K3 {k3:.1f} ms; "
        f"top {[(k[:40], round(v, 2)) for k, v in top]}")

    # fern's factor-8 frame: H, W not multiples of 8 → scanline order
    state = cli._restored_state(cfg, device)
    Hf, Wf = 378, 504
    ff = float(scene["focal"]) * Wf / scene["W"]

    def fern(plain):
        with torch.no_grad(), routed(plain):
            return render_image_blockwise(state.nets(), cfg, Hf, Wf, ff,
                                          scene["val_pose"],
                                          device=device)["rgb"]

    rgb_f = fern(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb_f = fern(False)
    torch.cuda.synchronize()
    secs_f = time.perf_counter() - t0
    p_fern = float(psnr(rgb_f, fern(True)))
    say("llff", f"{Hf}x{Wf} frame (scanline order) from the trained "
        f"checkpoint: {secs_f:.4f} s through the kernels "
        f"({Hf * Wf / secs_f:.1f} rays/s); PSNR against plain {p_fern:.2f} "
        f"dB (min {FRAME_PSNR_MIN})")
    checks["fern_frame"] = (p_fern >= FRAME_PSNR_MIN
                            and tuple(rgb_f.shape) == (Hf, Wf, 3)
                            and bool(torch.isfinite(rgb_f).all()))

    out_p = os.path.join(run, "parity")
    for name in ("fern", "orchids"):
        shutil.copytree(os.path.join(run, cfg.name, "ckpt"),
                        os.path.join(out_p, name, cfg.name, "ckpt"))
    rc, out, _, secs, _, _ = call("parity", f"data.root={root}",
                                  "data.llff_factor=1", dataset=None,
                                  out=out_p)
    rows = [json.loads(x) for x in out]
    say("llff", f"parity over {root} in {secs:.3f} s: {rows}")
    checks["parity"] = (rc == 0 and [r.get("scene") for r in rows[:2]]
                        == ["fern", "orchids"]
                        and rows[0]["anchor_psnr"] == 25.17
                        and rows[2]["scenes"] == 2
                        and all(math.isfinite(r["psnr"]) for r in rows[:2]))
    say("llff", f"checks {checks}; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"llff checks failed: {failed}")
    return llff_launches


def tryon_params(cfg, rng) -> dict:
    """The [tryon] state as the reference's params trees (numpy), made with
    no JAX: the committed flagship coarse and fine trees with the config's
    cond rows (cond_tree), a seeded garment encoder (LeCun-normal conv and
    dense kernels, zero biases) and, for a dynamic config, a seeded latent
    table (N(0, 1/dim)), as the reference initialises them."""
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.models.nerf_mlp import cond_width
    m = cfg.model
    trained, _ = load_flagship()
    params = {k: cond_tree(trained[k], cond_width(m), rng)
              for k in ("coarse", "fine")}
    chans = (7, 16, 32, 64)

    def dense(fan_in, shape):
        return {"kernel": (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
            np.float32), "bias": np.zeros(shape[-1], np.float32)}

    enc = {f"conv_{i}": dense(9 * chans[i], (3, 3, chans[i], chans[i + 1]))
           for i in range(3)}
    enc["proj"] = dense(chans[-1], (chans[-1], m.condition_dim))
    params["encoder"] = {"params": enc}
    if m.n_latents > 0:
        params["latents"] = {"params": {"codes": {"embedding": rng.normal(
            0.0, m.latent_dim ** -0.5, (m.n_latents, m.latent_dim)).astype(
                np.float32)}}}
    return params


def phase_tryon(device, gpu, smi):
    """The try-on serving path at viton_tryon's full width (8×256 coarse
    and fine fields, L = 10, a 64-wide garment code into trunk_0 and the
    skip layer; p64 + f96, chunk 16384):

    - `preprocess` of the procedural pair with the committed matcher: the
      cond .npy and the PNGs read back, the cond stack held to the same
      function on the CPU (PREPROCESS_ATOL); the matcher's held-out IoUs on
      the card against the asset's meta;
    - a conditioned state (tryon_params) carried into the port's state
      (`state_from_params`) and saved through `ckpt`;
    - the 800×800 frame at the scene's val pose (focal scaled by 800/H):
      the cond-aware occupancy sweep (K3's cond window) and a proposal
      distilled with the conditioned teacher, then the frame through K1 +
      K2, K1 + K6 and the plain versions (1 warm-up + 3 timed each through
      the kernels), each kernel frame against its plain frame and K6's
      against K2's; a second garment (procedural pair seed 1) gives another
      frame;
    - `eval` (through the kernels and with kernels.use_pallas=false) and
      `render` of the checkpoint; `render` of a dynamic_tryon checkpoint
      over 4 poses (latents 0-3), each kernel frame against its plain
      frame."""
    import shutil
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch import png
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.core.occupancy import build_from_config
    from fashion_nerf_torch.data.viton import synth_viton_pair
    from fashion_nerf_torch.kernels.posenc_mlp import make_fused_field
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.models.conditioned import encode_garment
    from fashion_nerf_torch.models.proposal import attach_proposal
    from fashion_nerf_torch.render import blockwise
    from fashion_nerf_torch.train.loop import (_eval_cond, load_dataset,
                                               resolve_garment)
    from fashion_nerf_torch.train.state import state_from_params
    from fashion_nerf_torch.tryon.matcher import eval_iou, load_matcher
    from fashion_nerf_torch.tryon.pipeline import (_preprocess_device,
                                                   build_conditioning,
                                                   to_device)
    t_phase = time.perf_counter()
    run = RUN_DIR + "_tryon"
    shutil.rmtree(run, ignore_errors=True)
    steps = f"proposal.distill_steps={TRYON_DISTILL_STEPS}"
    say("tryon", f"distillations run {TRYON_DISTILL_STEPS} steps "
        f"(proposal.distill_steps; the preset's is {DISTILL_STEPS}) to keep "
        "the phase short")
    checks = {}

    def call(argv, dataset=None):
        """cli.main → (exit code, stdout lines, stderr, seconds,
        launches)."""
        return cli_call(argv + ["--out", run], dataset, "tryon")[:5]

    # preprocess on the card, against the same function on the CPU
    rc, out, _, secs, _ = call(["preprocess", "--config", "viton_tryon"])
    row = json.loads(out[-1])
    cond_card = np.load(os.path.join(row["out"], "synthetic_cond.npy"))
    imgs = [png.read_png(os.path.join(row["out"], f"synthetic_{n}.png"))
            for n in ("agnostic", "warped_cloth", "tryon_overlay")]
    pair = synth_viton_pair()
    cpu = _preprocess_device(*to_device(pair, "cpu"), H=64, W=64,
                             matcher=load_matcher(device="cpu"))["cond"]
    e_pre = float(np.abs(cond_card - cpu.numpy()).max())
    t0 = time.perf_counter()
    iou = eval_iou(load_matcher(device=device),
                   list(range(2_000_000, 2_000_016)), device=device)
    iou_s = time.perf_counter() - t0
    say("tryon", f"preprocess in {secs:.3f} s: {json.dumps(row)}; cond stack "
        f"{cond_card.shape} against the CPU's {e_pre:.3g} (tol "
        f"{PREPROCESS_ATOL}); PNGs {[i.shape for i in imgs]}; matcher "
        f"held-out IoU on the card learned {iou[0]:.4f}, baseline "
        f"{iou[1]:.4f} (the asset's {MATCHER_IOU}, tol {MATCHER_IOU_TOL}) in "
        f"{iou_s:.2f} s")
    checks["preprocess"] = (
        rc == 0 and row["matcher"] and row["pairs"] == 1
        and cond_card.shape == (64, 64, 7) and e_pre <= PREPROCESS_ATOL
        and all(i.shape == (64, 64, 3) and i.std() > 1.0 for i in imgs))
    checks["matcher_iou"] = all(abs(a - b) <= MATCHER_IOU_TOL
                                for a, b in zip(iou, MATCHER_IOU))

    # the conditioned state, saved through ckpt
    cfg = load_config("viton_tryon", [f"out_dir={run}", steps])
    rng = np.random.default_rng(8)
    state = state_from_params(cfg, tryon_params(cfg, rng),
                              torch.Generator(device=device).manual_seed(0),
                              device)
    ckpt_lib.save(os.path.join(run, cfg.name, "ckpt"), state)
    scene = load_dataset(cfg, device)
    nets = state.nets()
    garment = resolve_garment(cfg, scene, scene["H"], scene["W"], device)
    cond = _eval_cond(cfg, nets, garment)

    # setup: the cond-aware sweep through K3, the conditioned teacher
    field = make_fused_field()
    K.reset_launches()
    t0 = time.perf_counter()
    occ = build_from_config(cfg, lambda p, v, c: field(state.fine, p, v, c),
                            device=device, cond=cond)
    params = attach_proposal(cfg, nets, occ=occ, cond=cond, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = dict(K.LAUNCHES)
    checks["setup"] = ("proposal" in params
                       and setup_launches["field_cond"] > 0
                       and int(occ.boxes_occ.sum()) > 0)

    H = W = FRAME
    focal = float(scene["focal"]) * FRAME / scene["H"]
    pose = scene["val_pose"]
    generic = load_config("viton_tryon", [f"out_dir={run}", steps,
                                          "kernels.carry_hoist=false"])

    def frame(c, cfg_, plain=False):
        with torch.no_grad(), routed(plain):
            return blockwise.render_image_blockwise(
                params, cfg_, H, W, focal, pose, occ=occ, device=device,
                cond=c)

    frames, secs, launches = {}, {}, {}
    for label, cfg_ in (("K1 + K2", cfg), ("K1 + K6", generic)):
        K.reset_launches()
        frame(cond, cfg_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            frames[label] = frame(cond, cfg_)
        torch.cuda.synchronize()
        secs[label] = (time.perf_counter() - t0) / 3
        launches[label] = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        frames[label + " plain"] = frame(cond, cfg_, plain=True)
        torch.cuda.synchronize()
        secs[label + " plain"] = time.perf_counter() - t0
    rgb2, rgb6 = frames["K1 + K2"]["rgb"], frames["K1 + K6"]["rgb"]
    p2 = float(psnr(rgb2, frames["K1 + K2 plain"]["rgb"]))
    p6 = float(psnr(rgb6, frames["K1 + K6 plain"]["rgb"]))
    p62 = float(psnr(rgb6, rgb2))
    live = frames["K1 + K2"]["chunk_live"]
    n_chunks = -(-H * W // cfg.render.chunk)
    n_live = launches["K1 + K2"]["sigma_march"] // 4  # one K1 a live chunk
    # a second garment: the procedural pair of seed 1
    g1 = build_conditioning(synth_viton_pair(seed=1), 64, 64, cfg=cfg,
                            device=device)
    with torch.no_grad():
        cond1 = encode_garment(nets["encoder"], g1)
    rgb_g1 = frame(cond1, cfg)["rgb"]
    dg = maxerr(rgb_g1, rgb2)
    say("tryon", f"setup: occupancy 64³ through K3's cond window + a "
        f"proposal distilled with the cond teacher in {setup_s:.2f} s, "
        f"launches {setup_launches}; {H}x{W} frame at the val pose: "
        f"{secs['K1 + K2']:.4f} s through K1 + K2, {secs['K1 + K6']:.4f} s "
        f"through K1 + K6 (1 warm-up + 3), plain {secs['K1 + K2 plain']:.4f}"
        f" and {secs['K1 + K6 plain']:.4f} s; PSNR K2 vs plain {p2:.2f} dB, "
        f"K6 vs plain {p6:.2f} dB, K6 vs K2 {p62:.2f} dB (min "
        f"{FRAME_PSNR_MIN}); live chunks {n_live}/{n_chunks}; acc max "
        f"{float(frames['K1 + K2']['acc'].max()):.4f}; the seed-1 garment's "
        f"frame differs by {dg:.4g} (max abs); launches {launches}; "
        f"{gpu} | {smi}")
    checks["frames"] = (
        p2 >= FRAME_PSNR_MIN and p6 >= FRAME_PSNR_MIN
        and p62 >= FRAME_PSNR_MIN and 0 < n_live < n_chunks
        and bool(live.any()) and not bool(live.all())
        and tuple(rgb2.shape) == (H, W, 3) and bool(torch.isfinite(rgb2).all())
        and float(frames["K1 + K2"]["acc"].max()) > 0.5 and dg > 1e-3
        and all(launches["K1 + K2"][k] > 0 for k in ("sigma_march",
                                                    "slim_march_cond"))
        and launches["K1 + K6"]["carry_march_cond"] > 0
        and launches["K1 + K2"]["slim_march"] == 0)
    del frames, params, occ

    # the command line from the checkpoint
    base = ["--config", "viton_tryon", "--set", steps]
    rc, out, _, secs_k, launches_e = call(["eval"] + base, scene)
    row_k = json.loads(out[-1])
    rc_p, out, _, secs_p, launches_p = call(
        ["eval"] + base + ["--set", "kernels.use_pallas=false"], scene)
    row_p = json.loads(out[-1])
    say("tryon", f"eval: {json.dumps(row_k)} in {secs_k:.3f} s through the "
        f"kernels, launches {launches_e}; {json.dumps(row_p)} in "
        f"{secs_p:.3f} s with kernels.use_pallas=false (dense, plain), "
        f"launches {sum(launches_p.values())} (tol {CLI_PSNR_TOL} dB)")
    checks["eval"] = (
        rc == 0 and rc_p == 0 and row_k["n_views"] == 1
        and abs(row_k["psnr"] - row_p["psnr"]) <= CLI_PSNR_TOL
        and all(launches_e[k] > 0 for k in ("field_cond", "sigma_march",
                                            "slim_march_cond"))
        and not any(launches_p.values()))
    rc, out, err, secs_r, launches_r = call(["render"] + base, scene)
    row = json.loads(out[-1])
    pngs = [png.read_png(os.path.join(row["out"], f"{i:03d}.png"))
            for i in range(row["frames"])]
    say("tryon", f"render: {row['frames']} frames in {secs_r:.3f} s, "
        f"launches {launches_r}")
    checks["render"] = (rc == 0 and row["frames"] == len(scene["poses"])
                        and all(p.shape == (64, 64, 3) for p in pngs)
                        and min(p.std() for p in pngs) > 1.0
                        and launches_r["slim_march_cond"] > 0)

    # dynamic_tryon over 4 poses (latents 0-3): the kernel frames beside
    # the plain versions' on the same inputs
    cfg_d = load_config("dynamic_tryon", [f"out_dir={run}", steps])
    state_d = state_from_params(cfg_d, tryon_params(cfg_d, rng),
                                torch.Generator(device=device), device)
    ckpt_lib.save(os.path.join(run, cfg_d.name, "ckpt"), state_d)
    scene_d = load_dataset(cfg_d, device)
    scene_d["poses"] = scene_d["poses"][:4]
    seen = []
    render_fn = blockwise.render_image_blockwise

    def recording(*a, **kw):
        out_k = render_fn(*a, **kw)
        with routed(True):
            out_p = render_fn(*a, **kw)
        seen.append((out_k["rgb"], out_p["rgb"], kw["cond"]))
        return out_k

    blockwise.render_image_blockwise = recording
    try:
        rc, out, _, secs_d, launches_d = call(
            ["render", "--config", "dynamic_tryon", "--set", steps], scene_d)
    finally:
        blockwise.render_image_blockwise = render_fn
    row_d = json.loads(out[-1])
    p_d = [float(psnr(a, b)) for a, b, _ in seen]
    distinct = len({tuple(c.tolist()) for _, _, c in seen})
    say("tryon", f"dynamic_tryon render: {row_d['frames']} frames in "
        f"{secs_d:.3f} s (each beside its plain frame), PSNR kernel vs plain"
        f" {[round(p, 2) for p in p_d]} dB (min {FRAME_PSNR_MIN}); distinct "
        f"cond vectors {distinct}; launches {launches_d}")
    checks["dynamic"] = (rc == 0 and row_d["frames"] == 4 and len(seen) == 4
                         and min(p_d) >= FRAME_PSNR_MIN and distinct == 4
                         and launches_d["slim_march_cond"] > 0)
    say("tryon", f"checks {checks}; phase {time.perf_counter() - t_phase:.1f}"
        f" s; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"tryon checks failed: {failed}")
    return {**setup_launches, **{
        k: launches["K1 + K2"][k] + launches["K1 + K6"][k]
        for k in ("slim_march_cond", "carry_march_cond")}}


def phase_tryon_train(device, gpu, smi):
    """Conditioned training at the try-on presets' full width (8×256 coarse
    and fine fields, L = 10, a 64-wide garment code, and for dynamic_tryon
    a 32-wide latent of a 64-code table, into trunk_0 and the skip layer;
    2048-ray batches of 64 + 128 samples, the sparsity prior on):

    - `train --config viton_tryon --resume` (cli.main) from a checkpoint of
      the [tryon] fixture (the committed flagship nets with cond rows, a
      seeded encoder) on the hermetic viton scene, TRYON_TRAIN_STEPS steps
      through a cond-aware occupancy refresh, culled and dense steps, an
      eval and a checkpoint: the loss falls, K3's cond window and K4's
      conditioned plan launch;
    - the same from init, and `eval` of its checkpoint four ways: blockwise
      through the kernels and through their plain versions (the same grid
      and distilled proposal), densely through K3 and densely plain.
      The kernels must agree with their plain versions on each path; the
      blockwise and the dense readings may differ (on a field 24 steps
      from init the culling and the proposal decide what is sampled), and
      that gap is printed;
    - one dynamic_tryon step from the [tryon] fixture through the kernels
      against the plain step (as [step]: the plain step with its own fine
      samples and with the kernel step's), every gradient of coarse, fine,
      encoder and latents; then full steps of both timed (rays/s);
    - `eval` of the trained viton checkpoint through the kernels and with
      kernels.use_pallas=false (the plain dense renderer);
    - DYNAMIC_TRAIN_STEPS steps of `train --config dynamic_tryon`: the
      trained frames' latents move, each its own way;
    - `train_matcher` at the reference's unit-test recipe (MATCHER_RECIPE)
      on the card: held-out IoU learned > baseline + MATCHER_MARGIN."""
    import shutil
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.render import blockwise, renderer
    from fashion_nerf_torch.train.loop import (TrainStep, load_dataset,
                                               resolve_garment,
                                               sparsity_points)
    from fashion_nerf_torch.train.state import (create_train_state,
                                                state_from_params)
    from fashion_nerf_torch.tryon.matcher import eval_iou, train_matcher
    t_phase = time.perf_counter()
    run = RUN_DIR + "_tryon_train"
    shutil.rmtree(run, ignore_errors=True)
    checks = {}

    def call(cmd, preset, dataset, *overrides, flags=(), out_dir=run):
        """cli.main → (exit code, stdout lines, seconds, launches)."""
        argv = [cmd, "--config", preset, "--out", out_dir, *flags]
        argv += [x for kv in overrides for x in ("--set", kv)]
        rc, out, _, secs, launches, _ = cli_call(argv, dataset,
                                                 "tryon-train")
        return rc, out, secs, launches

    def logged(lines, key):
        """The logger's JSON entries that carry `key`."""
        pre = "[fashion-nerf-torch] "
        entries = [json.loads(x[len(pre):]) for x in lines
                   if x.startswith(pre)]
        return [e for e in entries if key in e]

    # train --config viton_tryon --resume from the fixture's checkpoint,
    # through a refresh, an eval and a checkpoint
    cfg = load_config("viton_tryon", [f"out_dir={run}"])
    scene = load_dataset(cfg, device)
    ckpt_dir = os.path.join(run, cfg.name, "ckpt")
    ckpt_lib.save(ckpt_dir, state_from_params(
        cfg, tryon_params(cfg, np.random.default_rng(8)),
        torch.Generator(device=device).manual_seed(0), device))
    steps = TRYON_TRAIN_STEPS
    train_ovr = [f"train.iters={steps}", "train.log_every=4",
                 "train.occ_train=true", "train.occ_warmup=4",
                 "train.occ_refresh_every=1000", "train.occ_dense_every=8",
                 f"train.eval_every={steps}", f"train.ckpt_every={steps}",
                 f"proposal.distill_steps={TRYON_DISTILL_STEPS}"]
    rc, out, secs, launches = call("train", "viton_tryon", scene, *train_ovr,
                                   flags=["--resume"])
    logs = logged(out, "loss")
    evals = [e["val_psnr"] for e in logged(out, "val_psnr")]
    distill = f"proposal.distill_steps={TRYON_DISTILL_STEPS}"
    rate = statistics.median(e["rays_per_sec"] for e in logs[1:])
    last = logs[-1]
    say("tryon-train", f"train --config viton_tryon --resume from the "
        f"fixture's checkpoint: {steps} steps in "
        f"{secs:.2f} s; loss {logs[0]['loss']:.5f} at step {logs[0]['step']}"
        f" → {last['loss']:.5f} at step {last['step']} (both dense); "
        f"sparsity {last['sparsity']:.4g}; refreshes {last['refreshes']}, "
        f"culled steps {last['culled_steps']}, dense steps "
        f"{last['dense_steps']}; eval {evals}; checkpoints "
        f"{ckpt_lib.steps(ckpt_dir)}; {rate:.1f} rays/s (median of the log "
        f"windows after the first); launches {launches}; {gpu} | {smi}")
    checks["train"] = (
        rc == 0 and all(math.isfinite(e["loss"]) for e in logs)
        and last["loss"] < logs[0]["loss"] and last["refreshes"] >= 1
        and last["culled_steps"] >= 1 and last["dense_steps"] >= 1
        and len(evals) == 1 and math.isfinite(evals[0])
        and ckpt_lib.steps(ckpt_dir) == [0, steps]
        and all(launches[k] > 0 for k in ("field_cond", "field_bwd_cond",
                                          "volrend"))
        and launches["field_bwd"] == 0)

    # the same from init; its checkpoint's eval blockwise through the
    # kernels and their plain versions, and densely through K3 and plain
    init_run = run + "_init"
    rc_i, out, secs_i, launches_i = call("train", "viton_tryon", scene,
                                         *train_ovr, out_dir=init_run)
    logs_i = logged(out, "loss")
    render_fn = blockwise.render_image_blockwise
    seen = []

    def recording(*a, **kw):
        out_k = render_fn(*a, **kw)
        with routed(True):
            out_p = render_fn(*a, **kw)
        seen.append((out_k["rgb"], out_p["rgb"]))
        return out_k

    readings, rcs = {}, [rc_i]
    for label, ovr in (("blockwise", ()),
                       ("dense K3", ("kernels.blockwise=false",)),
                       ("dense plain", ("kernels.use_pallas=false",))):
        blockwise.render_image_blockwise = recording
        try:
            rc, out, _, lau = call("eval", "viton_tryon", scene, distill,
                                   *ovr, out_dir=init_run)
        finally:
            blockwise.render_image_blockwise = render_fn
        rcs.append(rc)
        readings[label] = (json.loads(out[-1])["psnr"], lau)
    val = torch.as_tensor(np.asarray(scene["val_image"]),
                          dtype=torch.float32, device=device)
    (rgb_k, rgb_p), = seen
    readings["blockwise plain"] = (float(psnr(rgb_p, val)), {})
    p_kp = float(psnr(rgb_k, rgb_p))
    bw, bw_p = readings["blockwise"][0], readings["blockwise plain"][0]
    dk, dp = readings["dense K3"][0], readings["dense plain"][0]
    say("tryon-train", f"train --config viton_tryon from init: {steps} "
        f"steps in {secs_i:.2f} s, loss {logs_i[0]['loss']:.5f} → "
        f"{logs_i[-1]['loss']:.5f}, launches {launches_i}; eval of its "
        f"checkpoint (val PSNR, dB): blockwise through the kernels {bw:.4f},"
        f" blockwise plain {bw_p:.4f} (the two frames {p_kp:.2f} dB apart, "
        f"min {FRAME_PSNR_MIN}), dense through K3 {dk:.4f}, dense plain "
        f"{dp:.4f}; blockwise − dense {bw - dp:+.4f} (tol kernel vs plain "
        f"{CLI_PSNR_TOL}); launches "
        f"{ {k: v[1] for k, v in readings.items() if v[1]} }")
    checks["from init"] = (
        all(r == 0 for r in rcs) and launches_i["field_bwd_cond"] > 0
        and abs(bw - bw_p) <= CLI_PSNR_TOL and abs(dk - dp) <= CLI_PSNR_TOL
        and p_kp >= FRAME_PSNR_MIN
        and readings["blockwise"][1]["slim_march_cond"] > 0
        and readings["dense K3"][1]["field_cond"] > 0
        and not any(readings["dense plain"][1].values()))
    shutil.rmtree(init_run, ignore_errors=True)

    # one dynamic_tryon step from the fixture: kernels against plain
    cfg_d = load_config("dynamic_tryon", ["sampling.perturb=false"])
    scene_d = load_dataset(cfg_d, device)
    ds = RayDataset(scene_d["images"], scene_d["poses"], scene_d["focal"],
                    device=device)
    garment = resolve_garment(cfg_d, scene_d, ds.H, ds.W, device)
    params_d = tryon_params(cfg_d, np.random.default_rng(9))
    idx = torch.from_numpy(np.random.default_rng(1).choice(
        ds.n_rays, cfg_d.train.batch_rays, replace=False)).to(device)
    batch = {k: v[idx] for k, v in ds.batch_arrays().items()}
    pts = sparsity_points(cfg_d, torch.Generator(device=device).manual_seed(
        2), device)
    sample_pdf = renderer.sample_pdf
    fine_t = []

    def fixture():
        return state_from_params(cfg_d, params_d, torch.Generator(
            device=device).manual_seed(0), device)

    def loss_and_grads(plain, replay):
        def sampler(*a, **kw):
            if replay:
                return fine_t[0]
            fine_t.append(sample_pdf(*a, **kw))
            return fine_t[-1]

        state = fixture()
        step = TrainStep(cfg_d, ds, streamed=True, garment=garment)
        renderer.sample_pdf = sampler
        K.reset_launches()
        try:
            with torch.enable_grad(), routed(plain):
                loss, _ = step.loss(state, batch, sparsity_pts=pts)
                loss.backward()
        finally:
            renderer.sample_pdf = sample_pdf
        torch.cuda.synchronize()
        grads = {f"{k}.{n}": p.grad for k, net in state.nets().items()
                 for n, p in net.named_parameters()}
        return float(loss), grads, dict(K.LAUNCHES)

    loss_k, grads_k, step_launches = loss_and_grads(False, False)
    report = []
    for label, replay, tol in (("own fine samples", False,
                                STEP_GRAD_SAMPLES_REL),
                               ("the kernel step's fine samples", True,
                                STEP_GRAD_REL)):
        loss_p, grads_p, _ = loss_and_grads(True, replay)
        e_loss = abs(loss_k - loss_p) / abs(loss_p)
        rel = {k: rel_rms(grads_k[k], grads_p[k]) for k in grads_p}
        worst = max(rel, key=rel.get)
        nets = sorted({k.split(".")[0] for k in rel})
        enc = max(v for k, v in rel.items() if k.startswith("encoder"))
        report.append(f"plain step with {label}: loss {loss_p:.7g} (rel "
                      f"{e_loss:.3g}, tol {STEP_LOSS_REL}), worst gradient "
                      f"relative RMS {rel[worst]:.3g} ({worst}, tol {tol}) "
                      f"over {len(rel)} parameters of {nets}; encoder's "
                      f"worst {enc:.3g}, latents "
                      f"{rel['latents.codes.weight']:.3g}")
        checks[f"step, {label}"] = (e_loss <= STEP_LOSS_REL
                                    and rel[worst] <= tol
                                    and nets == ["coarse", "encoder", "fine",
                                                 "latents"])
    step_secs = {}
    for plain in (False, True):
        state = fixture()
        step = TrainStep(cfg_d, ds, streamed=True, garment=garment)
        with torch.enable_grad(), routed(plain):
            step(state, batch, sparsity_pts=pts)          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step(state, batch, sparsity_pts=pts)
            torch.cuda.synchronize()
        step_secs[plain] = (time.perf_counter() - t0) / 3
    rays = cfg_d.train.batch_rays
    say("tryon-train", f"dynamic_tryon step from the fixture, loss through "
        f"the kernels {loss_k:.7g}, launches {step_launches}; "
        + "; ".join(report))
    say("tryon-train", f"conditioned training step ({rays} rays × "
        f"{cfg_d.sampling.n_coarse} + {cfg_d.sampling.n_fine} samples, the "
        f"prior's {cfg_d.train.sparsity_points} points): "
        f"{step_secs[False] * 1e3:.1f} ms through the kernels "
        f"({rays / step_secs[False]:.1f} rays/s), {step_secs[True] * 1e3:.1f}"
        f" ms plain ({rays / step_secs[True]:.1f} rays/s), mean of 3; {gpu} "
        f"| {smi}")
    checks["step launches"] = (step_launches["field_bwd_cond"] == 4
                               and step_launches["field_cond"] == 4
                               and step_launches["field_bwd"] == 0)
    del grads_k, state, step
    fine_t.clear()
    torch.cuda.empty_cache()

    # eval of the trained viton checkpoint: kernels against plain dense
    rc, out, secs_k, launches_e = call("eval", "viton_tryon", scene, distill)
    row_k = json.loads(out[-1])
    rc_p, out, secs_p, launches_p = call("eval", "viton_tryon", scene,
                                         distill, "kernels.use_pallas=false")
    row_p = json.loads(out[-1])
    say("tryon-train", f"eval of the trained checkpoint: {json.dumps(row_k)}"
        f" in {secs_k:.3f} s through the kernels, launches {launches_e}; "
        f"{json.dumps(row_p)} in {secs_p:.3f} s with kernels.use_pallas="
        f"false (dense, plain) (tol {CLI_PSNR_TOL} dB)")
    checks["eval"] = (rc == 0 and rc_p == 0
                      and abs(row_k["psnr"] - row_p["psnr"]) <= CLI_PSNR_TOL
                      and launches_e["field_cond"] > 0
                      and not any(launches_p.values()))

    # a few dynamic_tryon steps: the trained frames' latents move
    dsteps = DYNAMIC_TRAIN_STEPS
    rc, out, secs_d, launches_d = call(
        "train", "dynamic_tryon", scene_d, f"train.iters={dsteps}",
        "train.log_every=2", f"train.ckpt_every={dsteps}",
        "train.eval_every=1000")
    cfg_dt = load_config("dynamic_tryon", [f"out_dir={run}"])
    chain = GeneratorChain(cfg_dt.train.seed)
    init = create_train_state(cfg_dt, chain.once("init"),
                              chain.once("run", device), device)
    codes0 = init.latents.codes.weight.detach()
    payload = torch.load(os.path.join(run, cfg_dt.name, "ckpt",
                                      f"step_{dsteps:08d}.pt"),
                         map_location=device, weights_only=True)
    moves = payload["nets"]["latents"]["codes.weight"][:4] - codes0[:4]
    moved = [float(m.abs().max()) for m in moves]
    apart = min(float((moves[i] - moves[j]).abs().max())
                for i in range(4) for j in range(i + 1, 4))
    d_logs = logged(out, "loss")
    say("tryon-train", f"train --config dynamic_tryon: {dsteps} steps in "
        f"{secs_d:.2f} s, loss {[round(e['loss'], 5) for e in d_logs]}; "
        f"latents 0-3 moved by {[f'{m:.3g}' for m in moved]} (max abs), "
        f"their moves at least {apart:.3g} apart; launches {launches_d}")
    checks["dynamic"] = (rc == 0 and min(moved) > 0 and apart > 0
                         and all(math.isfinite(e["loss"]) for e in d_logs)
                         and launches_d["field_bwd_cond"] > 0)

    # train_matcher at the reference's unit-test recipe
    t0 = time.perf_counter()
    with torch.enable_grad():
        matcher, hist = train_matcher(
            generator=torch.Generator().manual_seed(0), device=device,
            **MATCHER_RECIPE)
    torch.cuda.synchronize()
    secs_m = time.perf_counter() - t0
    learned, base = eval_iou(matcher, list(MATCHER_HELD_OUT),
                             H=MATCHER_RECIPE["H"], W=MATCHER_RECIPE["W"],
                             device=device)
    say("tryon-train", f"train_matcher {MATCHER_RECIPE}: {secs_m:.2f} s "
        f"({secs_m / MATCHER_RECIPE['steps'] * 1e3:.1f} ms a step), loss "
        f"{hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f}; held-out IoU "
        f"(seeds {MATCHER_HELD_OUT.start}-{MATCHER_HELD_OUT.stop - 1}) "
        f"learned {learned:.4f}, baseline {base:.4f} (bar: baseline + "
        f"{MATCHER_MARGIN})")
    checks["matcher"] = (learned > base + MATCHER_MARGIN
                         and all(math.isfinite(h["loss"]) for h in hist))
    say("tryon-train", f"checks {checks}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"tryon-train checks failed: {failed}")
    return launches


def dist_state(cfg, device):
    """The state `train()` starts from (the run's seed)."""
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.train.state import create_train_state
    chain = GeneratorChain(cfg.train.seed)
    return create_train_state(cfg, chain.once("init"),
                              chain.once("run", device), device)


def write_blender_scene(root, scene) -> str:
    """The hermetic training scene in the blender layout (RGB PNGs,
    transforms_{train,val,test}.json; the val view is the test view too),
    for the launched ranks, which load it by path."""
    from fashion_nerf_torch.png import write_png
    os.makedirs(root, exist_ok=True)
    H, W = scene["images"].shape[1:3]
    angle = 2.0 * math.atan(0.5 * W / float(scene["focal"]))

    def frames(split, images, poses):
        out = []
        for i, (img, pose) in enumerate(zip(images, poses)):
            name = f"{split}/r_{i}"
            os.makedirs(os.path.join(root, split), exist_ok=True)
            write_png(os.path.join(root, name + ".png"),
                      (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
            m = np.eye(4)
            m[:3, :4] = np.asarray(pose)[:3, :4]
            out.append({"file_path": name, "transform_matrix": m.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": out}, f)

    frames("train", scene["images"], scene["poses"])
    for split in ("val", "test"):
        frames(split, [scene["val_image"]], [scene["val_pose"]])
    return root


def torchrun(argv, label: str, out_dir: str, nproc: int = DIST_RANKS,
             env=None, phase: str = "dist") -> tuple:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    nproc` of argv from the repo root, with `env` added to this process's
    environment → (stdout, stderr, seconds). The launcher and its ranks run
    in a session of their own, killed whole when they outlast DIST_JOIN_S."""
    import signal
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="4", **(env or {}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DIST_JOIN_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"[{phase}] {label}: the ranks did not finish "
                             f"in {DIST_JOIN_S} s and were killed")
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{label}.log"), "w") as f:
        f.write(f"$ {' '.join(cmd)}\n--- stdout\n{out}\n--- stderr\n{err}")
    if proc.returncode != 0:
        raise AssertionError(f"[{phase}] {label} failed ({proc.returncode}):"
                             f"\n{out[-3000:]}\n{err[-6000:]}")
    return out, err, secs


def one_card_env() -> dict:
    """The environment that shows a launcher's ranks the first visible card
    only: [dist]'s ranks share one card over gloo on any machine."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return {"CUDA_VISIBLE_DEVICES": visible}


def dist_steps(cfg, ds, device, mesh=None, n=DIST_CHECK_STEPS) -> dict:
    """n steps of `TrainStep` from the state `train()` starts from (the
    run's seed) → losses, the first step's (reduced) gradients, the full
    parameters after the last, and under tp each leaf's master and Adam
    moment shapes."""
    from fashion_nerf_torch.dist import mesh as dmesh
    from fashion_nerf_torch.train.loop import TrainStep
    state = dist_state(cfg, device)
    if mesh is not None:
        state = dmesh.shard_state(mesh, state)
    step = TrainStep(cfg, ds, mesh=mesh)
    losses, grads, shapes = [], None, None
    with torch.enable_grad():
        for k in range(n):
            state, m = step(state, ds.batch_arrays())
            losses.append(float(m["loss"]))
            if k == 0:
                grads = {f"{a}.{b}": p.grad.detach().clone()
                         for a, net in state.nets().items()
                         for b, p in net.named_parameters()}
    opt = state.optimizer
    if isinstance(opt, dmesh.ShardedAdam):
        names = {id(p): f"{a}.{b}" for a, net in state.nets().items()
                 for b, p in net.named_parameters()}
        local = opt.adam.state_dict()["state"]
        shapes = {names[id(p)]: (tuple(p.shape), tuple(m.shape),
                                 tuple(local[i]["exp_avg"].shape), s)
                  for i, (p, m, s) in enumerate(zip(
                      opt.full, opt.masters, opt.sharded))}
    torch.cuda.synchronize()
    return {"losses": losses, "grads": grads, "shapes": shapes,
            "params": {f"{a}.{b}": p.detach().clone()
                       for a, net in state.nets().items()
                       for b, p in net.named_parameters()}}


def far_share(a: dict, b: dict, gap: float) -> float:
    bad = sum(int(((a[k] - b[k]).abs() > gap).sum()) for k in b)
    return bad / sum(v.numel() for v in b.values())


def steps_against(label: str, res: dict, single: dict) -> tuple:
    """A group's `dist_steps` against one process's, held to [dist]'s
    bounds (step-1 loss DIST_LOSS_REL relative, every step-1 gradient
    DIST_GRAD_REL relative RMS, under DIST_PARAM_SHARE of the parameters
    more than DIST_PARAM_GAP apart after the steps) → (held, line)."""
    e_loss = abs(res["losses"][0] - single["losses"][0]) / abs(
        single["losses"][0])
    rel = {k: rel_rms(res["grads"][k], g) for k, g in single["grads"].items()}
    worst = max(rel, key=rel.get)
    share = far_share(res["params"], single["params"], DIST_PARAM_GAP)
    line = (f"{label}: losses {[round(x, 7) for x in res['losses']]} against "
            f"one process {[round(x, 7) for x in single['losses']]}; step-1 "
            f"loss rel {e_loss:.3g} (tol {DIST_LOSS_REL}); worst step-1 "
            f"gradient relative RMS {rel[worst]:.3g} ({worst}, tol "
            f"{DIST_GRAD_REL}) over {len(rel)} parameters; after "
            f"{len(res['losses'])} steps {share:.4%} of parameters more than "
            f"{DIST_PARAM_GAP} apart (tol {DIST_PARAM_SHARE:.0%})")
    held = (e_loss <= DIST_LOSS_REL and rel[worst] <= DIST_GRAD_REL
            and share < DIST_PARAM_SHARE)
    return held, line


def checkpoint_eval(cfg, run: str, root: str, ds_dict: dict, device,
                    phase: str) -> tuple:
    """The run's checkpoint restored in this process and `evaluate`d,
    beside `cli eval` of the run (dense, K3 + K5 off the culling) → (held
    within CLI_PSNR_TOL, line)."""
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch.data.pipeline import RayDataset
    from fashion_nerf_torch.train import loop
    restored = ckpt_lib.restore(os.path.join(run, cfg.name, "ckpt"),
                                dist_state(cfg, device))
    ds_eval = RayDataset(ds_dict["images"], ds_dict["poses"],
                         ds_dict["focal"], device=device)
    ds_eval.val_image, ds_eval.val_pose = (ds_dict["val_image"],
                                           ds_dict["val_pose"])
    _, p_one = loop.evaluate(cfg, restored, ds_eval)
    rc, lines, _, secs_e, _, _ = cli_call(
        ["eval", "--config", "blender_lego", "--out", run, "--set",
         f"data.root={root}", "--set", "occupancy.enabled=false", "--set",
         "kernels.blockwise=false"], phase=phase)
    p_cli = json.loads(lines[-1])["psnr"]
    line = (f"checkpoint step {restored.step} restored in one process: "
            f"evaluate {p_one:.4f} dB; cli eval of the run (dense, K3 + K5 "
            f"off the culling) {p_cli:.4f} dB in {secs_e:.2f} s (tol "
            f"{CLI_PSNR_TOL} dB)")
    return (rc == 0 and restored.step == cfg.train.iters
            and abs(p_cli - p_one) <= CLI_PSNR_TOL), line


def fine_samples(cfg, nets, o, d, device):
    """The dense path's fine inputs for rays (o, d): 64 stratified coarse
    samples through K3, the 128 inverse-CDF samples → (rgb (R,192,3),
    σ (R,192), t (R,192)) of the fine field through K3."""
    from fashion_nerf_torch.core.sampling import sample_pdf, stratified_sample
    from fashion_nerf_torch.core.volrend import volume_render
    from fashion_nerf_torch.kernels.posenc_mlp import field_for
    field_c = field_f = field_for(cfg)
    s = cfg.sampling
    t_c = stratified_sample(cfg.render.near, cfg.render.far, o.shape[0],
                            s.n_coarse, device=device)
    rgb_c, sig_c = field_c(nets["coarse"], o[:, None] + d[:, None]
                           * t_c[..., None], d)
    w = volume_render(rgb_c, sig_c, t_c, d)["weights"]
    t_f = sample_pdf(0.5 * (t_c[:, 1:] + t_c[:, :-1]), w[:, 1:-1], s.n_fine)
    t = torch.sort(torch.cat([t_c, t_f], -1), -1).values
    rgb, sigma = field_f(nets["fine"], o[:, None] + d[:, None] * t[..., None],
                         d)
    return rgb.contiguous(), sigma.contiguous(), t.contiguous()


def cli_on_group(argv, row: dict, label: str) -> None:
    """cli.main(argv) on this rank's group with its output captured: its
    exit code, stdout, stderr, ms and K3/K4/K5 launches go into `row`
    under `label`."""
    import contextlib
    import io
    from fashion_nerf_torch import cli
    from fashion_nerf_torch import kernels as K
    out, err = io.StringIO(), io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        row[f"{label}_rc"] = cli.main(argv)
    torch.cuda.synchronize()
    row["ms"][label] = (time.perf_counter() - t0) * 1e3
    row["launches"][label] = {k: K.LAUNCHES[k]
                              for k in ("field", "field_bwd", "volrend")}
    row[f"{label}_stdout"] = out.getvalue()
    row[f"{label}_stderr"] = err.getvalue()


def dp_render(cfg, nets, scene, ds, device, mesh, row: dict) -> None:
    """`render_image` of a DIST_FRAME² dense frame (K3, K5) of the val pose
    over the mesh's dp ranks, and on rank 0 the same frame in this process
    alone: their ms, the group's launches and rank 0's PSNR between the two
    go into `row`."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.dist import mesh as dmesh
    from fashion_nerf_torch.metrics import psnr
    from fashion_nerf_torch.render.renderer import render_image
    from fashion_nerf_torch.kernels.posenc_mlp import field_for
    field_c = field_f = field_for(cfg)
    fc = (lambda pts, vd, *c: field_c(nets["coarse"], pts, vd, *c))
    ff = (lambda pts, vd, *c: field_f(nets["fine"], pts, vd, *c))
    focal = float(scene["focal"]) * DIST_FRAME / ds.W
    frame = (lambda m: render_image(         # noqa: E731
        fc, ff, DIST_FRAME, DIST_FRAME, focal, scene["val_pose"], cfg,
        use_fused_render=True, device=device, mesh=m))
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = frame(mesh)["rgb"]
    torch.cuda.synchronize()
    row["ms"]["render_mesh"] = (time.perf_counter() - t0) * 1e3
    row["launches"]["render"] = {k: K.LAUNCHES[k]
                                 for k in ("field", "field_bwd", "volrend")}
    if dmesh.rank() == 0:
        t0 = time.perf_counter()
        one = frame(None)["rgb"]
        torch.cuda.synchronize()
        row["ms"]["render_one"] = (time.perf_counter() - t0) * 1e3
        row["render"] = {"shape": list(img.shape),
                         "psnr": float(psnr(img, one)),
                         "finite": bool(torch.isfinite(img).all())}


def dist_worker(job_path: str) -> int:
    """One rank of [dist]'s group (started by `python -m
    torch.distributed.run --nproc_per_node 2 chip_smoke.py --dist-worker
    JOB`): `train --set dist.dp=2` through `cli.main` on the group, the
    dp=2 and dp=1×tp=2 steps, `segmented_ray_scan` at 2 segments on the
    flagship's fine samples, and `render_image` over dp=2 against the same
    frame in this process; each rank's K3/K4/K5 launches per path. Rank 0
    writes the tensors and every rank its JSON line to the job's
    directory."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.core.volrend import volume_render
    from fashion_nerf_torch.data.pipeline import ray_dataset
    from fashion_nerf_torch.dist import mesh as dmesh
    from fashion_nerf_torch.dist.segmented import segmented_ray_scan
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.train.loop import load_dataset
    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    backend = dmesh.init_distributed(device=device)
    rank = dmesh.rank()
    row = {"rank": rank, "backend": backend, "launches": {}, "ms": {}}

    def counts():
        return {k: K.LAUNCHES[k] for k in ("field", "field_bwd", "volrend")}

    # `train --set dist.dp=2` through the command line, on this group
    cli_on_group(job["cli"], row, "cli")

    cfg = load_config("blender_lego", job["overrides"])
    scene = load_dataset(cfg, device)
    ds = ray_dataset(cfg, scene["images"], scene["poses"], scene["focal"],
                     device=device)

    for label, (dp, tp) in (("dp2", (2, 1)), ("tp2", (1, 2))):
        mesh = dmesh.make_mesh(dp, tp)
        K.reset_launches()
        t0 = time.perf_counter()
        res = dist_steps(cfg, ds, device, mesh)
        row["ms"][label] = (time.perf_counter() - t0) * 1e3
        row["launches"][label] = counts()
        if rank == 0:
            torch.save(res, os.path.join(job["out"], f"{label}.pt"))
        del res

    # segmented_ray_scan: the flagship's fine samples of 8192 rays of the
    # val view, split in two along the samples
    trained, _ = load_flagship()
    nets = {k: load_flax_params(trained[k],
                                compute_dtype=cfg.model.compute_dtype,
                                device=device) for k in ("coarse", "fine")}
    o, d = ds.rays_o[-2 * SEG_RAYS:-SEG_RAYS], ds.rays_d[-2 * SEG_RAYS:-SEG_RAYS]
    K.reset_launches()
    rgb, sigma, t = fine_samples(cfg, nets, o, d, device)
    for x in (rgb, sigma, t):          # rank 0's, bitwise on both
        dmesh.broadcast_([x])
    S = sigma.shape[1] // dmesh.world_size()
    cols = slice(rank * S, (rank + 1) * S)
    seg = lambda: segmented_ray_scan(        # noqa: E731
        None, rgb[:, cols].contiguous(), sigma[:, cols].contiguous(),
        t[:, cols].contiguous(), d, white_bkgd=True)
    got = seg()
    row["ms"]["segmented"] = cuda_ms(seg)
    row["launches"]["segmented"] = counts()
    if rank == 0:
        ref = volume_render(rgb, sigma, t, d, white_bkgd=True)
        row["segmented"] = {
            "shape": list(sigma.shape),
            **{k: maxerr(got[k], ref[k]) for k in ("rgb", "depth", "acc")},
            "volume_render_ms": cuda_ms(lambda: volume_render(
                rgb, sigma, t, d, white_bkgd=True))}

    # render_image over dp=2: a DIST_FRAME² dense frame, K3 and K5
    dp_render(cfg, nets, scene, ds, device, dmesh.make_mesh(2, 1), row)
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dmesh.shutdown_distributed()
    return 0


def phase_dist(scene, device, gpu, smi):
    """Distribution (`fashion_nerf_torch.dist`) at blender_lego's full width
    on the one card: two ranks over gloo, each on cuda:0.

    - one group started by `python -m torch.distributed.run
      --nproc_per_node 2 chip_smoke.py --dist-worker`: `train --set
      dist.dp=2` through `cli.main` for DIST_STEPS steps on the hermetic
      scene written in the blender layout, beside `train()` in this
      process from the same seed (the loss curves side by side); 3 steps under dp=2
      and under dp=1×tp=2 against the same steps here (step-1 loss, every
      step-1 gradient, the parameters after 3 steps; the tp shards'
      shapes), `segmented_ray_scan` at 2 segments against `volume_render`,
      `render_image` over dp=2 against one process; K3/K4/K5 launches per
      rank;
    - the dp=2 checkpoint restored here, and `cli eval` of it against
      `evaluate` of the restored weights;
    - `train()` with data.stream=true: its batches against
      `host_batch_iter`'s, the step time with the prefetch against the
      device gather's, and the device's busy share over a profiler window.
    Two ranks on one card measure no scaling: their rays/s are labelled so.
    """
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data import pipeline
    from fashion_nerf_torch.train import loop
    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(base, ignore_errors=True)
    root = write_blender_scene(os.path.join(base, "scene"), scene)
    run = os.path.join(base, "run")
    common = [f"data.root={root}", f"train.iters={DIST_STEPS}",
              "train.log_every=1", f"train.eval_every={DIST_STEPS}",
              f"train.ckpt_every={DIST_STEPS}"]
    cfg = load_config("blender_lego", common + [f"out_dir={run}"])
    checks = {}

    # 1. one group of two ranks: `train --set dist.dp=2` through the
    # command line, then the worker's checks
    argv = ["train", "--config", "blender_lego", "--out", run, "--set",
            "dist.dp=2"]
    for o in common:
        argv += ["--set", o]
    work = os.path.join(base, "worker")
    os.makedirs(work)
    job = os.path.join(work, "job.json")
    with open(job, "w") as f:
        json.dump({"out": work, "cli": argv,
                   "overrides": [f"data.root={root}"]}, f)
    _, _, secs_w = torchrun([os.path.join(ROOT, "chip_smoke.py"),
                             "--dist-worker", job], "worker", base,
                            env=one_card_env())
    rows = []
    for r in range(DIST_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    out = rows[0]["cli_stdout"]
    meshes = [json.loads(ln) for r in rows
              for ln in r["cli_stderr"].splitlines()
              if ln.startswith('{"mesh"')]
    logs = [json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
            if ln.startswith('[fashion-nerf-torch] {"loss"')]
    evals = [json.loads(ln.split(" ", 1)[1])["val_psnr"]
             for ln in out.splitlines()
             if ln.startswith('[fashion-nerf-torch] {"step"')]
    summary = [ln for r in rows for ln in r["cli_stdout"].splitlines()
               if ln.startswith('{"done"')]
    # the same run in this process
    ds_dict = loop.load_dataset(cfg, device)
    t0 = time.perf_counter()
    with torch.enable_grad():
        _, hist = loop.train(
            dataclasses.replace(cfg, out_dir=os.path.join(base, "one")),
            dataset_dict=ds_dict, device=device, log_fn=lambda e: None)
    torch.cuda.synchronize()
    secs_one = time.perf_counter() - t0
    one = [h for h in hist if "loss" in h]
    curve = [(e["loss"], o["loss"]) for e, o in zip(logs, one)]
    rate2 = statistics.median(e["rays_per_sec"] for e in logs[1:])
    rate1 = statistics.median(e["rays_per_sec"] for e in one[1:])
    say("dist", f"torchrun --nproc_per_node {DIST_RANKS} chip_smoke.py "
        f"--dist-worker: {secs_w:.1f} s with start-up, of which `train "
        f"--set dist.dp=2` (cli.main on the group) {rows[0]['ms']['cli'] / 1e3:.1f}"
        f" s: {len(logs)} steps, exit {[r['cli_rc'] for r in rows]}; mesh "
        f"lines {meshes}; eval {evals}; summary lines {len(summary)}")
    say("dist", "loss curve, two ranks | one process: " + "; ".join(
        f"{i + 1}: {a:.6f} | {b:.6f}" for i, (a, b) in enumerate(curve)))
    say("dist", f"rays/s of two ranks sharing one card (no scaling "
        f"measured) {rate2:.1f}, one process {rate1:.1f} (median of the "
        f"log windows after the first; one process's {DIST_STEPS} steps + "
        f"eval {secs_one:.2f} s); {gpu} | {smi}")
    e1 = abs(curve[0][0] - curve[0][1]) / abs(curve[0][1])
    checks["cli"] = (len(logs) == DIST_STEPS and len(summary) == 1
                     and all(r["cli_rc"] == 0 for r in rows)
                     and len(meshes) == DIST_RANKS
                     and all(m["backend"] == "gloo" for m in meshes)
                     and all(math.isfinite(e["loss"]) for e in logs)
                     and e1 <= DIST_LOSS_REL and len(evals) == 1)

    # 2. the worker's steps against the same steps here
    wcfg = load_config("blender_lego", [f"data.root={root}"])
    ds = pipeline.ray_dataset(wcfg, ds_dict["images"], ds_dict["poses"],
                              ds_dict["focal"], device=device)
    single = dist_steps(wcfg, ds, device)
    for label in ("dp2", "tp2"):
        res = torch.load(os.path.join(work, f"{label}.pt"),
                         map_location=device, weights_only=False)
        checks[label], line = steps_against(label, res, single)
        say("dist", line)
        if label == "tp2":
            trunk = {k: v for k, v in res["shapes"].items()
                     if ".trunk." in k or ".feature." in k or ".view_0." in k}
            say("dist", "tp2 shards (full, master, Adam moment, sharded): "
                + "; ".join(f"{k} {v[0]}→{v[1]}/{v[2]}"
                            f"{'' if v[3] else ' replicated'}"
                            for k, v in trunk.items() if k.startswith(
                                "coarse")))
            rule_ok = all(
                v[3] == (v[1][0] * 2 == v[0][0]) and v[1] == v[2]
                for v in res["shapes"].values())
            heads = [k for k, v in res["shapes"].items() if v[3] and (
                "head" in k)]
            checks["tp2 shards"] = (rule_ok and not heads and sum(
                v[3] for v in res["shapes"].values()) == 2 * 2 * 10)
        del res
    for r in rows:
        say("dist", f"rank {r['rank']} ({r['backend']}): launches "
            f"{r['launches']}; ms {({k: round(v, 1) for k, v in r['ms'].items()})}")
    seg = rows[0]["segmented"]
    say("dist", f"segmented_ray_scan, 2 segments of {seg['shape']} (the "
        f"flagship's fine samples): against volume_render on the card rgb "
        f"{seg['rgb']:.3g}, acc {seg['acc']:.3g} (tol {SEG_ATOL}), depth "
        f"{seg['depth']:.3g} (tol {SEG_DEPTH_ATOL}); "
        f"{rows[0]['ms']['segmented']:.3f} ms a scan (gloo, host-staged), "
        f"volume_render {seg['volume_render_ms']:.3f} ms")
    checks["segmented"] = (seg["rgb"] <= SEG_ATOL and seg["acc"] <= SEG_ATOL
                           and seg["depth"] <= SEG_DEPTH_ATOL)
    ren = rows[0]["render"]
    say("dist", f"render_image over dp=2, {ren['shape']}: {ren['psnr']:.2f}"
        f" dB against one process (min {FRAME_PSNR_MIN}); "
        f"{rows[0]['ms']['render_mesh']:.1f} ms over two ranks, "
        f"{rows[0]['ms']['render_one']:.1f} ms in one")
    checks["render"] = ren["psnr"] >= FRAME_PSNR_MIN and ren["finite"]
    checks["launches"] = all(
        r["launches"][p][k] > 0 for r in rows
        for p, k in (("cli", "field"), ("cli", "field_bwd"),
                     ("cli", "volrend"), ("dp2", "field"), ("dp2", "field_bwd"),
                     ("tp2", "field"), ("tp2", "field_bwd"),
                     ("render", "field"), ("render", "volrend")))

    # 3. the dp=2 checkpoint in one process, and cli eval of it
    checks["checkpoint"], line = checkpoint_eval(cfg, run, root, ds_dict,
                                                 device, "dist")
    say("dist", "dp=2 " + line)

    # 4. data.stream
    seen = []
    real = loop.prefetch_to_device

    def recording(it, **kw):
        for b in real(it, **kw):
            seen.append({k: v.cpu() for k, v in b.items()})
            yield b

    scfg = load_config("blender_lego", common + [
        "data.stream=true", f"out_dir={os.path.join(base, 'stream')}"])
    loop.prefetch_to_device = recording
    K.reset_launches()
    try:
        with torch.enable_grad():
            _, shist = loop.train(scfg, dataset_dict=ds_dict, device=device,
                                  log_fn=lambda e: None)
    finally:
        loop.prefetch_to_device = real
    torch.cuda.synchronize()
    s_launch = dict(K.LAUNCHES)
    want = pipeline.host_batch_iter(ds.batch_arrays(), scfg.train.batch_rays,
                                    seed=scfg.train.seed)
    same = all(all(torch.equal(got[k], torch.from_numpy(w[k])) for k in w)
               for got, w in zip(seen[:DIST_STEPS], want))
    slogs = [h for h in shist if "loss" in h]

    # the streamed step against the device gather, and a profiler window
    def timed(streamed: bool, n: int) -> float:
        state = dist_state(scfg, device)
        step = loop.TrainStep(scfg, ds, streamed=streamed)
        it = pipeline.prefetch_to_device(pipeline.host_batch_iter(
            ds.batch_arrays(), scfg.train.batch_rays, seed=1), size=2,
            device=device)
        with torch.enable_grad():
            step(state, next(it) if streamed else ds.batch_arrays())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, next(it) if streamed else ds.batch_arrays())
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    ms = {lab: timed(s, 10) for lab, s in (("stream", True),
                                            ("gather", False))}
    state = dist_state(scfg, device)
    step = loop.TrainStep(scfg, ds, streamed=True)
    it = pipeline.prefetch_to_device(pipeline.host_batch_iter(
        ds.batch_arrays(), scfg.train.batch_rays, seed=1), size=2,
        device=device)
    with torch.enable_grad():
        step(state, next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                step(state, next(it))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.key_averages()) / 1e6
    say("dist", f"data.stream=true: {len(slogs)} steps of train(), loss "
        f"{slogs[0]['loss']:.5f} → {slogs[-1]['loss']:.5f}; the first "
        f"{min(len(seen), DIST_STEPS)} batches equal host_batch_iter's: "
        f"{same}; launches {s_launch}; a step {ms['stream']:.2f} ms with "
        f"the prefetch, {ms['gather']:.2f} ms with the device gather (mean "
        f"of 10); profiler window of 5 streamed steps: {wall * 1e3:.1f} ms, "
        f"device {busy * 1e3:.1f} ms (busy {busy / wall:.3f}, idle "
        f"{1 - busy / wall:.3f}; copies on the side stream counted in "
        f"full); {gpu} | {smi}")
    checks["stream"] = (same and len(seen) >= DIST_STEPS
                        and len(slogs) == DIST_STEPS
                        and all(math.isfinite(h["loss"]) for h in slogs)
                        and s_launch["field_bwd"] > 0)
    say("dist", f"checks {checks}; phase {time.perf_counter() - t_phase:.1f}"
        f" s; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"dist checks failed: {failed}")
    return rows


def multicard_worker(job_path: str) -> int:
    """One rank of [multicard]'s group (`python -m torch.distributed.run
    --nproc_per_node n chip_smoke.py --multicard-worker JOB`), on its own
    card over NCCL (`dist.mesh.card_plan`).

    mode "one", one process on the card: `train --set dist.dp=1` through
    `cli.main` (one process: no mesh), then a group of one rank over NCCL
    on the card (tests/torch_dist_worker.py `group_of_one`, the tests'
    check): 3 steps of TrainStep under make_mesh(1, 1) against the same
    steps without a mesh, bitwise, and `reduce_gradients`,
    `reduce_scalars` and `broadcast_` of a bool occupancy grid each giving
    back what it was given. mode "cards":
    `train --set dist.dp=n` through `cli.main` on the group, at the
    preset's batch and at n times it; MC_CHECK_STEPS steps under dp=n and
    dp=n/2×tp=2; `render_image` over dp=n. Every rank
    writes its JSON row (its card, backend, launches) and rank 0 the
    tensors to the job's directory."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data.pipeline import ray_dataset
    from fashion_nerf_torch.dist import mesh as dmesh
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.train.loop import load_dataset
    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    backend = dmesh.init_distributed()
    device = K.resolve_device()       # after the join: the rank's card
    rank = dmesh.rank()
    row = {"rank": rank, "card": torch.cuda.current_device(),
           "device": str(device), "backend": backend,
           "world": dmesh.world_size(), "launches": {}, "ms": {}}
    cfg = load_config("blender_lego", job["overrides"])
    scene = load_dataset(cfg, device)
    ds = ray_dataset(cfg, scene["images"], scene["poses"], scene["focal"],
                     device=device)

    def counts():
        return {k: K.LAUNCHES[k] for k in ("field", "field_bwd", "volrend")}

    if job["mode"] == "one":
        cli_on_group(job["cli"], row, "cli")
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from torch_dist_worker import group_of_one
        one = group_of_one(cfg, ds, device, MC_CHECK_STEPS)
        row["launches"]["steps"] = one.pop("launches")
        row.update(one)
    else:
        n = dmesh.world_size()
        cli_on_group(job["cli"], row, "cli")
        cli_on_group(job["weak"], row, "weak")
        for label, (dp, tp) in (("dp", (n, 1)), ("dptp", (n // 2, 2))):
            mesh = dmesh.make_mesh(dp, tp)
            K.reset_launches()
            t0 = time.perf_counter()
            res = dist_steps(cfg, ds, device, mesh, MC_CHECK_STEPS)
            row["ms"][label] = (time.perf_counter() - t0) * 1e3
            row["launches"][label] = counts()
            if rank == 0:
                torch.save(res, os.path.join(job["out"], f"{label}.pt"))
            del res
        trained, _ = load_flagship()
        nets = {k: load_flax_params(trained[k],
                                    compute_dtype=cfg.model.compute_dtype,
                                    device=device)
                for k in ("coarse", "fine")}
        dp_render(cfg, nets, scene, ds, device, dmesh.make_mesh(n, 1), row)
    row["launches_all"] = dict(K.LAUNCHES)
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dmesh.shutdown_distributed()
    return 0


def multicard_kernels(cfg, card) -> dict:
    """K1, K2, K3, K4, K5, K6 and P1 at one [kernels] shape each with
    their operands on `card` while torch's current device stays cuda:0
    (each wrapper launches on its operands' card: `kernels.on_cuda`,
    `launch_args`), against their plain versions there at [kernels]'s
    tolerances → {kernel: (largest error, held, launches)}. K3 the
    trained fine net on the 65,536-row sweep chunk (the rows rule), K1 and
    K2 and K6 the bench frame's chunk, K4 786,432 rows of the training
    step, K5 8192 rays × 192, P1 its chain+relu."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch import probe
    from fashion_nerf_torch.assets import load_flagship
    from fashion_nerf_torch.core.occupancy import build_from_config
    from fashion_nerf_torch.kernels import (carrymarch, posenc_mlp, render,
                                            sigmamarch, slimmarch)
    from fashion_nerf_torch.models.nerf_mlp import load_flax_params
    from fashion_nerf_torch.models.proposal import attach_proposal
    rng = np.random.default_rng(0)
    trained, _ = load_flagship()
    fine = load_flax_params(trained["fine"], compute_dtype="bfloat16",
                            device=card)
    params = attach_proposal(cfg, {"fine": fine}, device=card)
    net = posenc_mlp.pack_params(fine, hoist_x=False)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (65536, 3)).astype(
        np.float32)).to(card)
    dirs = torch.from_numpy(rng.normal(size=(1024, 3)).astype(
        np.float32)).to(card)
    dp = posenc_mlp.hoist_dirs(net, dirs).contiguous()
    field = posenc_mlp.make_fused_field()
    occ = build_from_config(cfg, lambda p, v: field(fine, p, v), device=card)
    ch = march_chunk(cfg, params, fine, occ, card)
    hit, bhit, tf, df, log_eps = ch.args2[3:]
    k6_args = (net, ch.args2[2], ch.o, ch.d, hit, bhit, tf, df, log_eps)
    R, S = 4096, 192
    n = R * S
    k4_dirs = torch.from_numpy(rng.normal(size=(R, 3)).astype(
        np.float32)).to(card)
    k4_args = (net, torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)).to(card), posenc_mlp.hoist_dirs(net, k4_dirs)
        .contiguous(), torch.from_numpy((1e-4 * rng.normal(size=(n, 3)))
                                        .astype(np.float32)).to(card),
        torch.from_numpy((1e-4 * rng.normal(size=n)).astype(np.float32))
        .to(card), S)
    t5 = torch.from_numpy(np.sort(rng.uniform(
        cfg.render.near, cfg.render.far, (8192, 192)), axis=1).astype(
        np.float32)).to(card)
    k5_args = (torch.from_numpy(rng.uniform(0, 1, (8192, 192, 3)).astype(
        np.float32)).to(card), torch.from_numpy(rng.normal(
            0.0, 20.0, (8192, 192)).astype(np.float32)).to(card), t5,
        torch.from_numpy(rng.uniform(0.9, 1.2, 8192).astype(np.float32))
        .to(card), cfg.render.white_bkgd)
    x, ws = probe.make_inputs(probe.P1_ROWS, probe.P1_WIDTH, probe.P1_DEPTH,
                              0.06, 7, card)
    far = cfg.render.far

    def k3_held(k, p):
        row_err = (k[0] - p[0]).abs().amax(dim=1)
        e_sig = float(((k[1] - p[1]).abs() / (1 + p[1].abs())).max())
        return (float(row_err.max()) <= K3_RGB_MAX
                and float((row_err > K3_RGB_ATOL).float().mean())
                <= K3_ROW_SHARE and e_sig <= K3_SIGMA_REL)

    def k4_held(k, p):
        return max(rel_rms(a, b) for a, b in zip(k, p)) <= K4_REL_RMS

    def probe_held(k, p):
        return (rel_rms(k, p) <= PROBE_REL_RMS
                and maxerr(k, p) <= PROBE_MAX_REL * float(p.abs().max()))

    def march_held(tol):
        def held(k, p):     # K1's w and acc, K2's rgb and w
            return max(maxerr(k[0], p[0]), maxerr(k[1], p[1])) <= tol
        return held

    def k6_held(k, p):
        err = {q: maxerr(a, b) for q, a, b in zip(("rgb", "depth", "acc",
                                                    "w"), k, p)}
        return (max(err["rgb"], err["acc"], err["w"]) <= K6_ATOL
                and err["depth"] <= K6_ATOL * far)

    def k5_held(k, p):
        err = [maxerr(a, b) for a, b in zip(k, p)]
        return max(err[0], err[2], err[3]) <= K5_ATOL and \
            err[1] <= K5_ATOL * far

    cases = (
        ("field", posenc_mlp.field_rows, posenc_mlp.field_rows_plain,
         (net, pts, dp, 64), k3_held),
        ("sigma_march", sigmamarch.sigma_march, sigmamarch.sigma_march_plain,
         ch.args1, march_held(K1_ATOL)),
        ("slim_march", slimmarch.slim_march, slimmarch.slim_march_plain,
         ch.args2, march_held(K2_ATOL)),
        ("carry_march", carrymarch.carry_march, carrymarch.carry_march_plain,
         k6_args, k6_held),
        ("field_bwd", posenc_mlp.field_rows_backward,
         posenc_mlp.field_rows_backward_plain, k4_args, k4_held),
        ("volrend", render.volrend, render.volrend_plain, k5_args, k5_held),
        ("probe_p1", lambda *a: probe.tc_chain(*a, "chain", True),
         lambda *a: probe.tc_chain_plain(*a, "chain", True), (x, ws),
         probe_held))
    out = {}
    for name, kernel, plain, args, held in cases:
        K.reset_launches()
        got = kernel(*args)
        launches = sum(K.LAUNCHES.values())
        want = plain(*args)
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        on_card = all(t.device == card for t in got_t)
        ok = (held(got, want) and on_card and launches > 0
              and torch.cuda.current_device() == 0)
        # the first output's error: rgb, w, d_pts or the chain's
        out[name] = (maxerr(got_t[0], want_t[0]), ok, launches)
        del got, want, got_t, want_t
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    return out


def phase_multicard(scene, device, gpu, smi) -> bool:
    """One rank a card over NCCL (`dist.mesh.card_plan`: on a host with a
    card for each rank, rank LOCAL_RANK on cuda:LOCAL_RANK), the layout
    users train in across cards. → whether the cross-card run was made.

    - always, a group of one rank on the card (`python -m
      torch.distributed.run --nproc_per_node 1 chip_smoke.py
      --multicard-worker`, tests/torch_dist_worker.py `group_of_one`):
      the NCCL group's card and backend, 3 steps of TrainStep under
      make_mesh(1, 1) bitwise equal to the steps without a mesh, and the
      collectives giving back what they were given;
    - on N ≥ 2 cards, n ranks (the largest power of two up to N and
      MC_MAX_RANKS), each on its own card over NCCL: `train --set dist.dp=n` through `cli.main` on the group (the
      mesh lines: backend nccl, each rank's cuda:N, no staging) beside
      `train()` in this process (training rays/s of n ranks against one
      process, at the preset's batch and at n times it), MC_CHECK_STEPS
      steps under dp=n and dp=n/2×tp=2 against this process's ([dist]'s
      bounds), `render_image` over dp=n ≥ FRAME_PSNR_MIN dB against one
      process, the dp=n checkpoint's `cli eval` against `evaluate` of the
      restored weights here, and K1–K6 and P1 on the last card from this
      process (`multicard_kernels`);
    - on one card it says the cross-card run was not possible."""
    import shutil
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.data import pipeline
    from fashion_nerf_torch.train import loop
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    base = os.path.join(ROOT, "build", "chip_smoke_multicard")
    shutil.rmtree(base, ignore_errors=True)
    root = write_blender_scene(os.path.join(base, "scene"), scene)
    overrides = [f"data.root={root}"]
    worker = [os.path.join(ROOT, "chip_smoke.py"), "--multicard-worker"]
    checks = {}

    def launch(mode: str, nproc: int, **job) -> list:
        work = os.path.join(base, mode)
        os.makedirs(work)
        path = os.path.join(work, "job.json")
        with open(path, "w") as f:
            json.dump({"mode": mode, "out": work, "overrides": overrides,
                       **job}, f)
        _, _, secs = torchrun(worker + [path], mode, base, nproc=nproc,
                              env=MC_ENV, phase="multicard")
        rows = []
        for r in range(nproc):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                rows.append(json.load(f))
        for r in rows:
            say("multicard", f"{mode}: rank {r['rank']} of {r['world']} on "
                f"{r['device']} (torch's current device cuda:{r['card']}), "
                f"backend {r['backend']}; launches {r['launches']}; "
                f"LAUNCHES {({k: v for k, v in r['launches_all'].items() if v})}"
                f"; ms {({k: round(v, 1) for k, v in r['ms'].items()})}")
        say("multicard", f"{mode}: {nproc} rank(s) in {secs:.1f} s with "
            "start-up")
        return rows

    common = overrides + [f"train.iters={DIST_STEPS}", "train.log_every=1",
                          f"train.eval_every={DIST_STEPS}",
                          f"train.ckpt_every={DIST_STEPS}"]

    def argv(out, sets, dp):
        a = ["train", "--config", "blender_lego", "--out", out, "--set",
             f"dist.dp={dp}"]
        for o in sets:
            a += ["--set", o]
        return a

    def rates(r, label):
        logs = [json.loads(ln.split(" ", 1)[1])
                for ln in r[f"{label}_stdout"].splitlines()
                if ln.startswith('[fashion-nerf-torch] {"loss"')]
        # all rays over all the time of the windows after the first (it
        # holds the warm-up); every window is one step of the same batch
        return logs, len(logs[1:]) / sum(1 / e["rays_per_sec"]
                                         for e in logs[1:])

    # 1. a group of one rank on the card; the one-process CLI run beside
    one, = launch("one", 1, cli=argv(os.path.join(base, "run_one"), common,
                                     1))
    logs1, rate_1 = rates(one, "cli")
    say("multicard", f"one: NCCL group of one rank on {one['device']}: "
        f"{MC_CHECK_STEPS} steps under make_mesh(1, 1), losses "
        f"{one['losses']}, bitwise equal to the steps without a mesh "
        f"{one['bitwise']}; collectives give back what they were given "
        f"{one['collectives']}; `train --set dist.dp=1` (one process, no "
        f"mesh) {rate_1:.1f} training rays/s (all rays over all the time "
        f"of the log windows after the first) over {len(logs1)} steps")
    checks["one"] = (one["backend"] == "nccl" and one["device"] == "cuda:0"
                     and one["card"] == 0 and all(one["bitwise"].values())
                     and all(one["collectives"].values())
                     and one["cli_rc"] == 0 and len(logs1) == DIST_STEPS
                     and one["launches"]["steps"]["field"] > 0
                     and one["launches"]["steps"]["field_bwd"] > 0)
    cross = n_cards >= 2
    if not cross:
        say("multicard", f"cross-card run not possible: {n_cards} CUDA "
            "device")
    else:
        # a power of two: the batch of 4096 rays splits over the dp ranks,
        # and dp × tp=2 takes them all
        n = 1 << (min(n_cards, MC_MAX_RANKS).bit_length() - 1)
        smi_all = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().replace("\n", "; ")
        run, run_weak = (os.path.join(base, "run"),
                         os.path.join(base, "run_weak"))
        cfg = load_config("blender_lego", common + [f"out_dir={run}"])
        batch = cfg.train.batch_rays
        weak = overrides + [f"train.iters={MC_WEAK_STEPS}",
                            "train.log_every=1", "train.eval_every=1000000",
                            "train.ckpt_every=1000000",
                            f"train.batch_rays={batch * n}"]
        rows = launch("cards", n, cli=argv(run, common, n),
                      weak=argv(run_weak, weak, n))
        meshes = [json.loads(ln) for r in rows
                  for ln in r["cli_stderr"].splitlines()
                  if ln.startswith('{"mesh"')]
        say("multicard", f"cards: mesh lines {meshes}")

        logs, rate_n = rates(rows[0], "cli")
        wlogs, rate_w = rates(rows[0], "weak")
        summary = [ln for r in rows for ln in r["cli_stdout"].splitlines()
                   if ln.startswith('{"done"')]
        e1 = abs(logs[0]["loss"] - logs1[0]["loss"]) / abs(logs1[0]["loss"])
        say("multicard", f"training rays/s (all rays over all the time of "
            f"the log windows after the first): {n} ranks, one a card over "
            f"NCCL, {rate_n:.1f} at {batch} rays a step ({rate_n / rate_1:.3f}× one process, "
            f"{DIST_STEPS} steps), {rate_w:.1f} at {batch * n} rays a step "
            f"({rate_w / rate_1:.3f}×, {MC_WEAK_STEPS} steps); one process "
            f"(the CLI, its own process) {rate_1:.1f} at {batch}; step-1 "
            f"loss {logs[0]['loss']:.6f} against one process's "
            f"{logs1[0]['loss']:.6f}; {gpu} | {smi_all}")
        checks["cli"] = (all(r["cli_rc"] == 0 and r["weak_rc"] == 0
                             for r in rows)
                         and len(logs) == DIST_STEPS
                         and len(wlogs) == MC_WEAK_STEPS
                         and len(summary) == 1 and len(meshes) == n
                         and all(m["backend"] == "nccl"
                                 and m["staging"] is None for m in meshes)
                         and sorted(m["device"] for m in meshes)
                         == [f"cuda:{i}" for i in range(n)]
                         and e1 <= DIST_LOSS_REL)
        checks["cards"] = all(r["backend"] == "nccl"
                              and r["device"] == f"cuda:{r['rank']}"
                              and r["card"] == r["rank"] for r in rows)
        checks["launches"] = all(
            r["launches"][p][k] > 0 for r in rows
            for p, k in (("cli", "field"), ("cli", "field_bwd"),
                         ("dp", "field"), ("dp", "field_bwd"),
                         ("render", "field"), ("render", "volrend")))
        ds_dict = loop.load_dataset(cfg, device)
        wcfg = load_config("blender_lego", overrides)
        ds = pipeline.ray_dataset(wcfg, ds_dict["images"], ds_dict["poses"],
                                  ds_dict["focal"], device=device)
        single = dist_steps(wcfg, ds, device, None, MC_CHECK_STEPS)
        for label, name in (("dp", f"dp={n}"), ("dptp", f"dp={n // 2}×tp=2")):
            res = torch.load(os.path.join(base, "cards", f"{label}.pt"),
                             map_location=device, weights_only=False)
            checks[label], line = steps_against(name, res, single)
            say("multicard", line)
            del res
        ren = rows[0]["render"]
        say("multicard", f"render_image over dp={n}, {ren['shape']}: "
            f"{ren['psnr']:.2f} dB against one process (min "
            f"{FRAME_PSNR_MIN}); {rows[0]['ms']['render_mesh']:.1f} ms over "
            f"{n} ranks, {rows[0]['ms']['render_one']:.1f} ms in one")
        checks["render"] = ren["psnr"] >= FRAME_PSNR_MIN and ren["finite"]
        checks["checkpoint"], line = checkpoint_eval(cfg, run, root, ds_dict,
                                                     device, "multicard")
        say("multicard", f"dp={n} " + line)
        card = torch.device("cuda", n_cards - 1)
        kern = multicard_kernels(cfg, card)
        say("multicard", f"kernels on {card} launched from a process whose "
            f"current device is cuda:0, against their plain versions there: "
            + "; ".join(f"{k} err {e:.3g} held {ok} launches {c}"
                        for k, (e, ok, c) in kern.items()))
        checks["kernels"] = all(ok for _, ok, _ in kern.values())
    say("multicard", f"checks {checks}; phase {time.perf_counter() - t_phase:.1f}"
        f" s; {gpu} | {smi}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"multicard checks failed: {failed}")
    return cross


def phase_times(root: str) -> int:
    """Run ROOT/chip_smoke.py (another checkout's, or this one's) with its
    output passed through, then print `[phase-times]`: the seconds spent
    before each of its lines summed by the line's [tag], so two trees'
    phases compare within one call."""
    import re
    tag = re.compile(r"^\[([\w-]+)\]")
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                            cwd=root, stdout=subprocess.PIPE, text=True)
    t_prev = t0 = time.perf_counter()
    spent = {}
    for line in proc.stdout:
        now = time.perf_counter()
        m = tag.match(line)
        key = m.group(1) if m else "untagged"
        spent[key] = spent.get(key, 0.0) + now - t_prev
        t_prev = now
        print(line, end="", flush=True)
    rc = proc.wait()
    print("[phase-times] " + json.dumps(
        {"root": root, "rc": rc, "total_s": time.perf_counter() - t0,
         "s": spent}), flush=True)
    return rc


# multiply-adds an evaluation of mip-NeRF 360's nets (perfbench/roofline.py
# counts the same from the layer shapes)
M360_MACS = {"fine": 7_787_264, "proposal": 215_296}


def phase_m360(device, gpu, smi) -> dict:
    """[m360]: K7 at the cell's shapes against its plain version and a
    torch.matmul chain, then a full-width frame against the reference."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.config import config_to_dict, load_config
    from fashion_nerf_torch.kernels import widefield as wf
    from fashion_nerf_torch.models.mipnerf360 import init_nets
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    sys.path.insert(0, ROOT)
    from perfbench.drivers.render import make_poses
    from perfbench.reference import mipnerf360 as ref
    cfg = load_config("mipnerf360")
    nets = {k: v.to(device) for k, v in init_nets(
        cfg, torch.Generator().manual_seed(0)).items()}
    results = {}
    K.reset_launches()
    for name, rows, spr in (("fine", 2_097_152, 32),
                            ("proposal", 4_194_304, 64)):
        p = wf.pack_wide(nets[name])
        g = torch.Generator(device=device).manual_seed(1)
        mean = torch.rand((rows, 3), generator=g, device=device) * 4 - 2
        var = torch.rand((rows, 3), generator=g, device=device) * 1e-3
        dp = (wf.dir_term(p, torch.randn((rows // spr, 3), generator=g,
                                         device=device)).contiguous()
              if p.has_vd else None)
        ms = cuda_ms(lambda: wf.wide_rows(p, mean, var, dp, spr), reps=5)
        rgb, sig = wf.wide_rows(p, mean, var, dp, spr)
        rgb_p, sig_p = wf.wide_rows_plain(p, mean, var, dp, spr)
        pms = cuda_ms(lambda: wf.wide_rows_plain(p, mean, var, dp, spr),
                      reps=1)
        # the same bf16 operands summed in another order: an activation
        # that rounds to the neighbouring bf16 on one side moves the rest
        # of its row by ~0.4% of that value; the largest σ gap over the
        # 2M rows read 1.24e-3 on an H100 (σ's spread 0.036)
        e_sig, r_sig = maxerr(sig, sig_p), rel_rms(sig, sig_p)
        spread = float(sig_p.std())
        if e_sig > 5e-3 or r_sig > 1e-2:
            raise RuntimeError(f"K7 {name}: σ off its plain version by "
                               f"{e_sig} (rel. rms {r_sig}, spread {spread})")
        e_rgb = maxerr(rgb, rgb_p) if p.has_vd else 0.0
        if e_rgb > 2e-3:
            raise RuntimeError(f"K7 {name}: rgb off by {e_rgb}")
        del rgb, sig, rgb_p, sig_p
        # the yardstick: the trunk (and the bottleneck) as torch.matmul
        # calls on bf16 operands of the same shapes
        W, x = p.width, torch.randn((rows, 128), device=device,
                                    dtype=torch.bfloat16)
        ws = [torch.randn((128 if i == 0 else W + (128 if (i - 1) in p.skips
                                                  else 0), W),
                          device=device, dtype=torch.bfloat16) * 0.03
              for i in range(p.depth)]
        w_bn = torch.randn((W, 256), device=device, dtype=torch.bfloat16)

        def chain():
            h = x
            for i, w in enumerate(ws):
                h = torch.relu((torch.cat([h, x], 1) if i and (i - 1)
                                in p.skips else h) @ w)
            return h @ w_bn if p.has_vd else h

        lib = cuda_ms(chain, reps=3)
        del x, ws, w_bn, mean, var, dp
        torch.cuda.empty_cache()
        b = bound(rows * 2 * M360_MACS[name],
                  rows * (40 if p.has_vd else 28))
        b["library_ms"] = lib
        results[name] = dict(max_abs_err=max(e_sig, e_rgb), ms=ms,
                             plain_ms=pms, **b)
        say("m360", f"K7 {name} ({p.depth}×{W}) on {rows} rows: kernel "
            f"{ms:.3f} ms, {bound_line(b, ms)}, plain {pms:.1f} ms, "
            f"library_ms {lib:.3f} (torch.matmul chain), max |σ err| "
            f"{e_sig:.2e}, rel. rms {r_sig:.2e} (σ spread {spread:.3f}), "
            f"max |rgb err| {e_rgb:.2e}")
    # the cell's frame (its size, field of view, first pose and chunk)
    # through the main path, the launches counted over it alone, held to
    # the cell's limits as the benchmark's comparison computes them
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "orbit40_bicycle4.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "checks",
                           "m360.render.orbit.json")) as f:
        limits = json.load(f)["limits"]
    H, W = traffic["frame"]
    focal = 0.5 * W / math.tan(0.5 * traffic["fov_x"])
    c2w = make_poses(traffic["poses"])[0]
    cfg = load_config("mipnerf360", [f"{k}={v}" for k, v in
                                     traffic["overrides"].items()])
    K.reset_launches()
    with torch.no_grad():
        got = render_image_blockwise(nets, cfg, H, W, focal, c2w,
                                     device=device)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    trees = {k: v.to_tree() for k, v in nets.items()}
    want = ref.render_frame(config_to_dict(cfg), ref.build(trees, device),
                            H, W, focal, c2w, device)
    err = (got["rgb"] - want["rgb"]).abs().reshape(-1)
    mae = float(err.mean())
    p99 = float(torch.quantile(err[::max(1, err.numel() // (1 << 24))].cpu(),
                               0.99))
    say("m360", f"{W}×{H} frame in {cfg.render.chunk}-ray chunks: "
        f"{launches['wide_field']} K7 launches; against the reference rgb "
        f"mae {mae:.3e} (limit {limits['rgb_mae']}), p99 {p99:.3e} "
        f"(limit {limits['rgb_p99']}), max {float(err.max()):.3e}; {gpu} | "
        f"{smi}")
    if mae > limits["rgb_mae"] or p99 > limits["rgb_p99"]:
        raise RuntimeError("the mip-NeRF 360 frame is off the reference")
    return {"results": results, "launches": launches}


# K7's backward against the truth: its plain version in f64 on the same
# kept bf16 activations, rounding its cotangents to bf16 at the same
# points. The kernel and the plain f32 version sum in other orders, so
# each flips some cotangents to the neighbouring bf16, and the flips carry
# down the layers; each parameter's gradient (relative Frobenius distance)
# is held within K7_BWD_FACTOR of the plain f32 version's distance to the
# same truth, or within K7_BWD_FLOOR of its norm, far below a bf16 step.
# The kernel against the plain f32 version alone, at the limit of
# tests/test_torch_m360_train.py (2e-3, which holds at 65,536 and 131,072
# rows), read 2.08e-3 on the NeRF MLP's first bias at the cell's 524,288
# rows: a sum over the rows that mostly cancels, in which both sides'
# flips show. Against the truth (NVIDIA H100 80GB HBM3, 700 W): kernel
# 2.05e-3, plain f32 1.13e-3 on that bias, the kernel 1.70-1.87 times the
# plain version on the NeRF MLP's four farthest leaves and 1.38-1.59 on
# the proposal's (the tensor cores' f32 sums flip more often than the
# plain f32 GEMM's, as K3's do); inputs and seeds are fixed, so the
# reading repeats
K7_BWD_FACTOR, K7_BWD_FLOOR = 2.0, 2e-4
# the rows of each piece of the f64 plain backward (whole rays)
K7_BWD_CHUNK = 65_536


def k7_bwd_truth(wf, packed, saved, g_rgb, g_sig, spr, rows, dtype):
    """`wide_bwd_plain` in `dtype` on K7's kept activations of `rows` rows,
    K7_BWD_CHUNK rows at a time, the weight gradients summed (so that f64
    fits beside the kernel's buffers) → its dict in f32."""
    def cast(x):
        return None if x is None else x.to(dtype)
    net = dataclasses.replace(
        packed, w_h=[cast(w) for w in packed.w_h],
        w_a=[cast(w) for w in packed.w_a],
        bias=[cast(b) for b in packed.bias],
        heads={k: cast(v) for k, v in packed.heads.items()},
        wp=None, b=None, wpt=None)
    W, D, c = packed.width, packed.depth, K7_BWD_CHUNK
    hs = saved["hs"].view(D, -1)
    total, dirs = None, []
    for r0 in range(0, rows, c):
        part = {"a0": saved["a0"][r0 * wf.IPE_COLS:(r0 + c) * wf.IPE_COLS],
                "hs": hs[:, r0 * W:(r0 + c) * W]}
        if packed.has_vd:
            part.update(
                bn=saved["bn"][r0 * wf.HEAD_BOTTLENECK:
                               (r0 + c) * wf.HEAD_BOTTLENECK],
                v=saved["v"][r0 * wf.HEAD_VIEW:(r0 + c) * wf.HEAD_VIEW],
                rgb=saved["rgb"][r0:r0 + c])
        kept = wf.plain_saved(packed, part, c)
        kept = {k: ([cast(x) for x in v] if k == "hs" else cast(v))
                for k, v in kept.items()}
        g = wf.wide_bwd_plain(net, kept, cast(g_rgb[r0:r0 + c])
                              if packed.has_vd else None,
                              cast(g_sig[r0:r0 + c]), spr)
        if packed.has_vd:
            dirs.append(g.pop("dirpart"))
        if total is None:
            total = g
            continue
        for k, v in g.items():
            total[k] = ([None if a is None else a + b
                         for a, b in zip(total[k], v)]
                        if isinstance(v, list) else total[k] + v)
    out = {k: ([None if a is None else a.float() for a in v]
               if isinstance(v, list) else v.float())
           for k, v in total.items()}
    if packed.has_vd:
        out["dirpart"] = torch.cat(dirs).float()
    return out


def phase_m360_train(device, gpu, smi) -> dict:
    """[m360-train]: K7's training forward and backward through
    `wide_field_train` (autograd) at the training cell's rows, each net one
    call as the step makes it: the launches counted over that call alone,
    each parameter's gradient against `wide_bwd_plain` on the same kept
    activations, and the backward's kernel, plain and torch.matmul times
    beside its bound."""
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.kernels import widefield as wf
    from fashion_nerf_torch.models.mipnerf360 import init_nets
    sys.path.insert(0, ROOT)
    from perfbench import m360_counts
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "m360_train16k.json")) as f:
        traffic = json.load(f)
    cfg = load_config("mipnerf360", [f"{k}={v}" for k, v in
                                     traffic["overrides"].items()])
    B = cfg.train.batch_rays
    nets = {k: v.to(device) for k, v in init_nets(
        cfg, torch.Generator().manual_seed(0)).items()}
    view_term = 3 + 6 * cfg.model.posenc_dir
    results, launches = {}, {}
    for name, spr in (("fine", cfg.sampling.n_fine),
                      ("proposal", cfg.proposal.eval_n)):
        net, rows = nets[name], B * spr
        params = dict(net.named_parameters())
        g = torch.Generator(device=device).manual_seed(1)
        mean = torch.rand((rows, 3), generator=g, device=device) * 4 - 2
        var = torch.rand((rows, 3), generator=g, device=device) * 1e-3
        vd = (torch.nn.functional.normalize(torch.randn(
            (B, 3), generator=g, device=device), dim=-1)
            if net.has_vd else None)
        g_rgb = (torch.randn((rows, 3), generator=g, device=device)
                 if net.has_vd else None)
        g_sig = torch.randn((rows,), generator=g, device=device)
        outs, cots = (([0, 1], [g_rgb, g_sig]) if net.has_vd
                      else ([1], [g_sig]))
        K.reset_launches()
        with torch.enable_grad():
            out = wf.wide_field_train(net, mean, var, vd, spr)
            _, packed, saved, *_ = out[1].grad_fn.state
            got = torch.autograd.grad([out[i] for i in outs],
                                      list(params.values()), cots)
        torch.cuda.synchronize()
        launches[name] = {k: K.LAUNCHES[k] for k in ("wide_field",
                                                     "wide_field_bwd")}
        if launches[name] != {"wide_field": 1, "wide_field_bwd": 1}:
            raise RuntimeError(f"K7 {name}: launches {launches[name]}, "
                               f"one forward and one backward expected")
        kept = wf.plain_saved(packed, saved, rows)
        want = wf._param_grads(net, packed, wf.wide_bwd_plain(
            packed, kept, g_rgb, g_sig, spr), vd)
        truth = wf._param_grads(net, packed, k7_bwd_truth(
            wf, packed, saved, g_rgb, g_sig, spr, rows, torch.float64), vd)
        gaps = {k: (rel_rms(a, t), rel_rms(b, t), rel_rms(a, b))
                for k, a, b, t in zip(params, got, want, truth)}
        top = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:4]
        say("m360-train", f"K7 {name}'s backward against the f64 truth, "
            f"the leaves farthest (kernel, plain f32, kernel to plain "
            f"f32): " + ", ".join(f"{k} " + "/".join(f"{x:.2e}" for x in v)
                                  for k, v in top))
        over = {k: v for k, v in gaps.items()
                if v[0] > max(K7_BWD_FACTOR * v[1], K7_BWD_FLOOR)}
        if over:
            raise RuntimeError(f"K7 {name}'s backward off the f64 truth "
                               f"(kernel, plain f32, kernel to plain): "
                               f"{over}")
        worst = max(gaps, key=lambda k: gaps[k][0])
        dp = wf.dir_term(packed, vd).contiguous() if net.has_vd else None
        fms = cuda_ms(lambda: wf._run_forward_train(packed, mean, var, dp,
                                                    spr), reps=5)
        bms = cuda_ms(lambda: wf._run_backward(packed, saved, g_rgb, g_sig,
                                               spr), reps=5)
        pms = cuda_ms(lambda: wf.wide_bwd_plain(packed, kept, g_rgb, g_sig,
                                                spr), reps=1)
        del kept, want, truth, got, out
        torch.cuda.empty_cache()
        # the yardstick: the backward's dgrad and wgrad products (the
        # trunk's, the skip's IPE columns', and with a view branch the
        # bottleneck's and the view layer's) as torch.matmul calls on bf16
        # operands of the same shapes
        W, bf = packed.width, torch.bfloat16

        def rnd(*shape):
            return torch.randn(shape, device=device, dtype=bf)

        h, dz, a0 = rnd(rows, W), rnd(rows, W), rnd(rows, 6 * packed.L)
        w = rnd(W, W)
        head = ((rnd(rows, wf.HEAD_BOTTLENECK), rnd(rows, wf.HEAD_VIEW),
                 rnd(W, wf.HEAD_BOTTLENECK),
                 rnd(wf.HEAD_BOTTLENECK, wf.HEAD_VIEW))
                if net.has_vd else None)

        def chain():
            for i in range(packed.depth - 1, -1, -1):
                if packed.w_h[i] is not None:
                    h.t() @ dz
                    dz @ w.t()
                if packed.w_a[i] is not None:
                    a0.t() @ dz
            if head is not None:
                dbn, dzv, w_bn, w_v = head
                h.t() @ dbn
                dbn @ w_bn.t()
                dbn.t() @ dzv
                dzv @ w_v.t()

        lib = cuda_ms(chain, reps=3)
        del h, dz, a0, w, head, saved, mean, var, vd, dp
        torch.cuda.empty_cache()
        tree = net.to_tree()
        b = bound(rows * m360_counts.bwd_flops(tree, view_term),
                  rows * m360_counts.bwd_bytes(tree))
        b["library_ms"] = lib
        results[name] = dict(max_rel_err=gaps[worst][0], ms=bms,
                             forward_ms=fms, plain_ms=pms, **b)
        say("m360-train", f"K7 {name} ({packed.depth}×{W}) under autograd "
            f"on {rows} rows ({B} rays × {spr}): launches "
            f"{launches[name]}; training forward {fms:.3f} ms; backward "
            f"{bms:.3f} ms, {bound_line(b, bms)}, plain {pms:.1f} ms, "
            f"library_ms {lib:.3f} (torch.matmul chain of the dgrad and "
            f"wgrad products); against the f64 truth the worst leaf "
            f"{worst}: kernel {gaps[worst][0]:.2e}, plain f32 "
            f"{gaps[worst][1]:.2e} of its norm, kernel to plain f32 "
            f"{gaps[worst][2]:.2e} (largest over the leaves "
            f"{max(v[2] for v in gaps.values()):.2e}); {gpu} | {smi}")
    return {"results": results, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "main path needs a CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        return dist_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--multicard-worker":
        return multicard_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--phase-times":
        return phase_times(sys.argv[2])
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch import kernels as K

    t_start = time.perf_counter()
    torch.set_grad_enabled(False)
    gpu, smi = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    cfg = load_config("blender_lego")
    if sys.argv[1:] == ["--only", "m360"]:
        phase_m360(device, gpu, smi)
        say("done", f"[m360] alone in {time.perf_counter() - t_start:.1f} s, "
            f"the build included; {gpu} | {smi}")
        return 0
    if sys.argv[1:] == ["--only", "m360-train"]:
        phase_m360_train(device, gpu, smi)
        say("done", f"[m360-train] alone in "
            f"{time.perf_counter() - t_start:.1f} s, the build included; "
            f"{gpu} | {smi}")
        return 0
    if sys.argv[1:] == ["--only", "multicard"]:
        scene, _ = phase_scene(cfg, device)
        phase_multicard(scene, device, gpu, smi)
        say("done", f"[multicard] alone in {time.perf_counter() - t_start:.1f}"
            f" s, the build included; {gpu} | {smi}")
        return 0
    results, occ_ref = phase_kernels(cfg, device)
    K.reset_launches()
    params, occ = phase_setup(cfg, device, occ_ref)
    render_launches, k2_rgb = phase_frame(cfg, device, params, occ, gpu, smi)
    del params, occ, occ_ref
    generic_launches = phase_frame_generic(device, k2_rgb, gpu, smi)
    phase_frame_twostage(device, k2_rgb, gpu, smi)
    propmarch_launches = phase_frame_propmarch(device, k2_rgb, gpu, smi)
    sb_launches = phase_frame_sb(device, k2_rgb, gpu, smi)
    del k2_rgb
    gate, gate_cache = phase_gate(device, gpu, smi)
    branch_launches = phase_branches(device, gate, gate_cache, gpu, smi)
    phase_sweep(device, gate_cache, gpu, smi)
    del gate, gate_cache
    torch.cuda.empty_cache()
    scene, ds = phase_scene(cfg, device)
    step = phase_step(device, ds, gpu, smi)
    phase_bench_train(device, step["step_s"], gpu, smi)
    phase_eval(device, ds)
    train_launches, _ = phase_train(scene, device, gpu, smi)
    phase_train_small(scene, device, gpu, smi)
    probe_launches = phase_probe(device, gpu, smi)
    phase_cli(scene, device, gpu, smi)
    phase_dist(scene, device, gpu, smi)
    phase_multicard(scene, device, gpu, smi)
    del scene, ds
    torch.cuda.empty_cache()
    llff_launches = phase_llff(device, gpu, smi)
    torch.cuda.empty_cache()
    tryon_launches = phase_tryon(device, gpu, smi)
    torch.cuda.empty_cache()
    tryon_train_launches = phase_tryon_train(device, gpu, smi)
    torch.cuda.empty_cache()
    m360 = phase_m360(device, gpu, smi)
    results["wide_field"] = m360["results"]["fine"]
    torch.cuda.empty_cache()
    m360_train = phase_m360_train(device, gpu, smi)
    results["wide_field_bwd"] = m360_train["results"]["fine"]
    say("done", f"all phases in {time.perf_counter() - t_start:.1f} s, the "
        f"build included; {gpu} | {smi}")
    # K1, K2 and K8 run on the render path, K6 on the carry_hoist=false render
    # path, K3, K4 and K5 on the training path, P1 and P2 on the probe; the
    # conditioned K3 on the try-on setup's sweep and teacher, the
    # conditioned K2 and K6 on the try-on frames, K4's conditioned plan on
    # the try-on trainer; K3 with the tile flag on llff_fern's bench
    # frames, K2 without a view branch on the sigma_march=false frames, K1,
    # K2 and K6 at SBs outside 16-64 on the frame-sb frames
    launches = {**{k: render_launches[k] for k in ("sigma_march",
                                                   "slim_march", "box_cull",
                                                   "block_hit")},
                "carry_march": generic_launches["carry_march"],
                **{k: train_launches[k] for k in ("field", "field_bwd",
                                                  "volrend")},
                **{k: probe_launches[k] for k in ("probe_p1", "probe_p2")},
                **{k: tryon_launches[k] for k in ("field_cond",
                                                  "slim_march_cond",
                                                  "carry_march_cond")},
                "field_bwd_cond": tryon_train_launches["field_bwd_cond"],
                "field_alive": llff_launches["field_alive"],
                "slim_march_novd": propmarch_launches["slim_march_novd"],
                "sigma_march_k2": branch_launches["sigma_march_k2"],
                **{k: sb_launches[k] for k in ("sigma_march_sb",
                                               "slim_march_sb",
                                               "carry_march_sb")},
                "wide_field": m360["launches"]["wide_field"],
                "wide_field_bwd": m360_train["launches"]["fine"][
                    "wide_field_bwd"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **results[name]} for name in ("sigma_march", "slim_march",
                                       "field", "field_bwd", "volrend",
                                       "carry_march", "probe_p1",
                                       "probe_p2", "field_cond",
                                       "slim_march_cond",
                                       "carry_march_cond",
                                       "field_bwd_cond", "field_alive",
                                       "slim_march_novd",
                                       "sigma_march_k2", "sigma_march_sb",
                                       "slim_march_sb", "carry_march_sb",
                                       "wide_field", "wide_field_bwd",
                                       "box_cull", "block_hit")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
