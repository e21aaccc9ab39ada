"""Tensor-core probe (P1, P2; kernel csrc/tcprobe.cu).

Counterpart of `scripts/mfu_probe.py`: how many bf16 tensor-core TFLOP/s a
hand-written chain of square products at the field's shape reaches on this
card. The kernel runs on the wgmma layer loop of the field kernels
(csrc/wg_trunk.cuh, the weight ring of csrc/wg_field.cuh) without their
sines, biases and heads, so its rate is that loop's ceiling. Run as

    python -m fashion_nerf_torch.probe [--shapes] [--device cpu|cuda]
                                       [--rows N]

P1 (`main`, the reference's `run_variant`): 2^21 rows through 9 chained
256×256 bf16 products with f32 accumulation and a bf16 cast per layer,
then one f32 product by W_0: `chain`, `chain+relu`, `chain f32hold` and
`2 streams` (two relu half chains over the even and the odd weights,
their f32 outputs summed). P2 (`--shapes`, the reference's `bench`): 2^20
rows through a width × depth sweep, a dependent chain (cast per layer,
f32 out) or an independent sum Σ_k x·W_k.

Two rows of the reference differ from a sibling only in their schedule,
not in what they compute. P1's `chain f32hold` (the cast moved to the
product's input) computes `chain+relu`: here it is the kernel's `hold`
mode, which keeps a layer's output in registers, packed as the next
layer's A fragments, and lets the wgmmas read A from there, so no layer
stores to shared memory. `chain+relu` stores each layer in shared memory
as the field kernels do, so the two rows are that loop's ceiling and what
holding the activations in registers would buy it. P2's `il=1` row (one
2048-row slice in place of four) computes `w256 d9 dependent`; the kernel
has no such knob, so it is reported as its own row and is the same launch
as its sibling. `2 streams` runs its two chains one after the other.

FLOP counts are the reference's: 2·W²·(depth + 1) per row for P1 (the
final product included), 2·W²·depth per row for P2. Times: 1 warm-up and
10 timed calls between CUDA events. Weights are N(0, 1)·0.06 (P1) or
·0.05 (P2) and inputs N(0, 1), rounded to bf16, drawn on the device from
a seed.

`tc_chain` takes the kernel on CUDA tensors and `tc_chain_plain`, the same
chain in torch with the same rounding points, on CPU tensors. The kernel
takes widths that are multiples of 256; other widths are zero-padded, and
shapes whose activation tiles do not fit in shared memory in one launch
are composed of its launches (`single_launch`, `_run`). The weights are
laid out for the kernel inside every call, so the times include it (the
reference's probe feeds plain (W, W) arrays too). Without a CUDA device
the probe raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from fashion_nerf_torch import kernels as K

_BF = torch.bfloat16
# mode → the kernel's mode; `hold` is the chain with its activations held
# in registers
MODES = {"chain": 0, "streams": 1, "dependent": 2, "independent": 3,
         "hold": 0}
# the launch counter of each mode's probe
_COUNTER = {"chain": "probe_p1", "streams": "probe_p1", "hold": "probe_p1",
            "dependent": "probe_p2", "independent": "probe_p2"}

PASS_COLS = 256       # columns of one wgmma pass; the kernel's widths are
MAX_WIDTH = 1024      # its multiples up to MAX_WIDTH (csrc/tcprobe.cu)

P1_ROWS, P2_ROWS = 1 << 21, 1 << 20
P1_WIDTH, P1_DEPTH = 256, 9
# (name, mode, relu, same launch as)
P1_VARIANTS = (("chain", "chain", False, None),
               ("chain+relu", "chain", True, None),
               ("chain f32hold", "hold", True, None),
               ("2 streams", "streams", True, None))
# (name, width, depth, mode, same launch as)
P2_SHAPES = (("w256 d9 dependent", 256, 9, "dependent", None),
             ("w256 d9 independent", 256, 9, "independent", None),
             ("w512 d9 dependent", 512, 9, "dependent", None),
             ("w512 d9 independent", 512, 9, "independent", None),
             ("w256 d9 dep il=1 (M=2048)", 256, 9, "dependent",
              "w256 d9 dependent"),
             ("w1024 d4 independent", 1024, 4, "independent", None))


def _mm(h, w):
    """bf16-valued operands, f32 products and f32 sums."""
    return h.float() @ w.float()


def tc_chain_plain(x, ws, mode: str, relu: bool = False):
    """Plain version: x (n, W) bf16, ws (depth, W, W) bf16 → (n, W) f32."""
    if mode in ("chain", "hold"):
        h = x
        for w in ws:
            v = _mm(h, w)
            h = (torch.relu(v) if relu else v).to(_BF)
        return _mm(h, ws[0])
    if mode == "streams":
        h1 = h2 = x
        for k in range(0, ws.shape[0] - 1, 2):
            h1 = torch.relu(_mm(h1, ws[k])).to(_BF)
            h2 = torch.relu(_mm(h2, ws[k + 1])).to(_BF)
        return _mm(h1, ws[0]) + _mm(h2, ws[1])
    if mode == "dependent":
        h = x
        for w in ws:
            h = _mm(h, w).to(_BF)
        return h.float()
    if mode == "independent":
        out = _mm(x, ws[0])
        for w in ws[1:]:
            out = out + _mm(x, w)
        return out
    raise ValueError(f"mode {mode!r}")


def pack_probe_weights(ws):
    """(depth, W, W) bf16, W a multiple of PASS_COLS → the kernel's weight
    stream: per layer and block of PASS_COLS output columns, the 64-row K
    slices in order, each in the K-major core-matrix layout of `wgpack`
    (element (k, n) of a slice at (n // 8)·512 + (k // 8)·64 + (n % 8)·8 +
    k % 8). One permuted copy on ws's device."""
    D, W, _ = ws.shape
    v = ws.reshape(D, W // 64, 8, 8, W // PASS_COLS, PASS_COLS // 8, 8)
    return v.permute(0, 4, 1, 5, 2, 6, 3).contiguous().reshape(-1)


def single_launch(mode: str, width: int, depth: int) -> bool:
    """Whether one launch of the kernel takes `mode` at this (padded)
    width: its activation tiles must fit in shared memory beside the
    weight ring (csrc/tcprobe.cu::probe_plan). A chain keeps two tiles a
    warpgroup once a layer is more than one column pass, two streams keep
    two tiles at one pass only; the independent sum and a one-layer
    dependent chain keep x alone."""
    if mode == "independent" or (mode == "dependent" and depth == 1):
        return width <= MAX_WIDTH
    if mode in ("streams", "hold"):
        return width == PASS_COLS
    return width <= 2 * PASS_COLS


def _launch(x, ws, mode: str, relu: bool, counter: str):
    """One launch of the kernel on padded inputs: x (n, W), ws (D, W, W)."""
    n, W = x.shape
    out = torch.empty((n, W), dtype=torch.float32, device=x.device)
    wp = pack_probe_weights(ws)
    code = K.library().fnt_tc_probe(x.data_ptr(), wp.data_ptr(),
                                    out.data_ptr(), n, W, ws.shape[0],
                                    int(relu), MODES[mode],
                                    int(mode == "hold"),
                                    *K.launch_args(x.device))
    K.raise_on_error(code, "fnt_tc_probe")
    K.LAUNCHES[counter] += 1
    return out


def _run(x, ws, mode: str, relu: bool, counter: str):
    """`mode` on padded inputs: one launch where the kernel takes the
    shape, else composed of its launches (but for `hold`, which raises
    beyond one pass). Two streams wider than one pass
    are two chains (over the even and the odd layers) whose f32 outputs
    are added; a chain wider than two passes runs layer by layer, each a
    one-layer dependent launch (bf16-rounded f32 out; the relu commutes
    with the rounding), its last product a one-layer independent launch."""
    W = x.shape[1]
    if single_launch(mode, W, ws.shape[0]):
        return _launch(x, ws, mode, relu, counter)
    if mode == "hold":
        raise ValueError(f"hold takes widths up to {PASS_COLS}: a wider "
                         "layer's output does not fit in registers")
    if mode == "streams":
        pairs = len(range(0, ws.shape[0] - 1, 2))
        return (_run(x, ws[0::2][:pairs], "chain", True, counter)
                + _run(x, ws[1::2][:pairs], "chain", True, counter))
    h = x
    for k in range(ws.shape[0]):
        v = _launch(h, ws[k:k + 1], "dependent", False, counter)
        if mode == "dependent" and k == ws.shape[0] - 1:
            return v
        h = (torch.relu(v) if relu else v).to(_BF)
    return _launch(h, ws[:1], "independent", False, counter)


def tc_chain(x, ws, mode: str, relu: bool = False):
    """The probe's chain: CPU tensors take the plain version, CUDA tensors
    the kernel (counted under probe_p1 or probe_p2 at every launch: one
    for the probe's own shapes). Any width that is a multiple of 16 up to
    MAX_WIDTH: a width the kernel does not take directly is zero-padded to
    the next multiple of PASS_COLS (zero columns stay exact zeros through
    relu and the bf16 cast, zero rows add exact zeros) and the output cut
    back. The weights are laid out for the kernel inside the call
    (`pack_probe_weights`), so the probe's times include it."""
    if K.on_cuda(x, ws) is None:
        return tc_chain_plain(x, ws, mode, relu)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    n, W = x.shape
    D = ws.shape[0]
    if n % K.SLAB_ROWS:
        raise ValueError(f"rows {n} not a multiple of {K.SLAB_ROWS}")
    if W < 16 or W % 16 or W > MAX_WIDTH:
        raise ValueError(f"width {W} not a multiple of 16 up to {MAX_WIDTH}")
    if D < 1 or (mode == "streams" and D < 2):
        raise ValueError(f"depth {D}: {mode} needs at least "
                         f"{2 if mode == 'streams' else 1} layers")
    K.check(x, "x", _BF, (n, W))
    K.check(ws, "ws", _BF, (D, W, W))
    Wp = -(-W // PASS_COLS) * PASS_COLS
    if Wp != W:
        x = F.pad(x, (0, Wp - W))
        ws = F.pad(ws, (0, Wp - W, 0, Wp - W))
    if n == 0:
        return torch.empty((0, W), dtype=torch.float32, device=x.device)
    out = _run(x, ws, mode, relu and mode in ("chain", "hold"),
               _COUNTER[mode])
    return out if Wp == W else out[:, :W].contiguous()


def make_inputs(n: int, width: int, depth: int, scale: float, seed: int,
                device):
    """x (n, W) ~ N(0, 1) and ws (depth, W, W) ~ N(0, 1)·scale, both
    rounded to bf16, drawn on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    ws = (torch.randn((depth, width, width), generator=g, device=device)
          * scale).to(_BF)
    x = torch.randn((n, width), generator=g, device=device).to(_BF)
    return x, ws


def time_ms(fn, device, iters: int = 10) -> float:
    """Mean milliseconds of fn() after one warm-up: CUDA events on a CUDA
    device, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _report(name: str, ms: float, flops: float, log, same=None) -> dict:
    tf = flops / (ms * 1e-3) / 1e12
    note = f"  (same launch as {same})" if same else ""
    log(f"{name:28s}: {ms:7.2f} ms  {tf:6.1f} TFLOP/s{note}")
    return {"name": name, "ms": ms, "tflops": tf, "same_as": same}


def run_p1(device, n: int = P1_ROWS, iters: int = 10, log=print) -> list:
    """P1: the four chain variants at W = 256, depth 9."""
    x, ws = make_inputs(n, P1_WIDTH, P1_DEPTH, 0.06, 0, device)
    flops = n * 2 * P1_WIDTH * P1_WIDTH * (P1_DEPTH + 1)
    rows = []
    for name, mode, relu, same in P1_VARIANTS:
        ms = time_ms(lambda: tc_chain(x, ws, mode, relu), device, iters)
        rows.append(_report(name, ms, flops, log, same))
    return rows


def run_p2(device, n: int = P2_ROWS, iters: int = 10, log=print) -> list:
    """P2: the width × depth sweep."""
    rows = []
    for name, width, depth, mode, same in P2_SHAPES:
        x, ws = make_inputs(n, width, depth, 0.05, 1, device)
        ms = time_ms(lambda: tc_chain(x, ws, mode), device, iters)
        rows.append(_report(name, ms, n * 2 * width * width * depth, log,
                            same))
        del x, ws
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", action="store_true",
                    help="P2: the width × depth sweep (default: P1)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows per call (default 2^21 for P1, 2^20 for P2)")
    args = ap.parse_args(argv)
    device = K.resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    print(f"device: {kind}", flush=True)
    if args.shapes:
        run_p2(device, n=args.rows or P2_ROWS)
    else:
        run_p1(device, n=args.rows or P1_ROWS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
