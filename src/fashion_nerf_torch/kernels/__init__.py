"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Ten kernels, CUDA C++ for sm_90a under `csrc/`:

- K1 `sigmamarch.cu`: the σ-only proposal march (kernels/sigmamarch.py);
- K2 `slimmarch.cu`: the multi-block march of the 8×256 field (or a
  128-wide one), and of a net without a view branch: the σ-only proposal
  net of the generic proposal march, and of the σ march at a proposal
  width K1 does not take (kernels/slimmarch.py);
- K3 `field.cu`: the fused posenc + MLP field, with the tile-skip flag of
  the two-stage march (kernels/posenc_mlp.py);
- K4 `field_bwd.cu`: the field's backward (kernels/posenc_mlp.py);
- K5 `volrend.cu`: the fused volume render (kernels/render.py);
- K6 `carrymarch.cu`: the generic carry march (kernels/carrymarch.py);
- P1/P2 `tcprobe.cu`: the tensor-core probe's bf16 chains (probe.py),
  counted as `probe_p1` (the field's chain) and `probe_p2` (the sweep);
- K7 `widefield.cu`: mip-NeRF 360's nets at widths 256 and 1024 on the
  integrated encoding of cone Gaussians, layer by layer
  (kernels/widefield.py), counted as `wide_field` (a render or training
  forward call) and `wide_field_bwd` (a training backward call);
- K8 `boxcull.cu`: occupancy culling against the macro boxes, the union
  interval a ray (`box_cull`) and the per-block flags of a march
  (`block_hit`), without the per-(ray, box) tensors (kernels/boxcull.py).

Every kernel with matrix products runs on Hopper's warpgroup matrix
multiply (`wgmma`) with its weights brought into shared memory by bulk
asynchronous copies behind mbarriers: K1 and K2 on the loop of
`csrc/wg_trunk.cuh`; K3, K4, K6 and the probe on that of
`csrc/wg_field.cuh` (a producer warpgroup streaming weight slices through
a ring to two consumer warpgroups); K7 on a loop of its own in the same
shape, whose ring carries the activation blocks beside the weight slices.
K5 and K8 have no matrix product and are plain CUDA. Shapes: K1 width 128
(the σ march of any other proposal width runs on K2 without a view branch,
zero-padded to its nearest width); K2 widths SLIM_WIDTHS with or without a
view branch, SB in MARCH_SB; K3, K4 and K6 widths FIELD_WIDTHS, depths
FIELD_DEPTHS and posenc operand widths FIELD_K0. A narrower net runs
zero-padded to the nearest shape (`posenc_mlp.pad_packed`: the same
function, at the padded net's cost in tensor-core time); the probe widths
that are multiples of 256 up to 1024, others zero-padded. Every packed net
may have any number of skip layers. What cannot be padded into the range
raises ValueError.

Path rule, the same in every wrapper: tensors on the CPU take the plain
PyTorch version; tensors on a CUDA device take the kernel, or the call
raises. Nothing falls back from one to the other. Inside `with
plain_versions():` CUDA tensors take the plain version too: the reference
runs on the card that the kernels are held against. A kernel launches on its
operands' card (`on_cuda` gives it; operands on two cards raise), on that
card's current stream (`launch_args`): several cards in one process, or one
rank a card, each run their own. The sources are built on
first use into one shared library under `build/fashion_nerf_torch/` at
the repo root, named by a hash of the sources and flags, and loaded with
ctypes: one nvcc per source, all started together, then one link. Each
wrapper adds one to its entry of `LAUNCHES` at every kernel launch (a
conditioned net's launches of K2, K3, K4 and K6 to their "_cond"
entries, K3's launches with the tile-skip flag to "field_alive", K2's
on a net without a view branch to "slim_march_novd", and K2's for the σ
march of a proposal K1 does not take to "sigma_march_k2"); a march's
launch at an SB outside SB_16_64 goes to its "_sb" entry instead
("sigma_march_sb", "slim_march_sb", "carry_march_sb").
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "fashion_nerf_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# MLP rows per predication tile: a march tile is TILE_ROWS // SB rays (the
# reference's _TILE), half that for a conditioned net (PackedNet.tile_rows).
# Part of the result: every ray of a live tile is marched.
TILE_ROWS = 2048
# rows of one consumer warpgroup's tile (csrc/fnt_common.cuh kRows): row
# counts are its multiples
SLAB_ROWS = 64
# samples per block the marches K1, K2 and K6 take: the reference's
# (sigmamarch_pallas.py:160-162, slimmarch_pallas.py:255,
# blockmarch_pallas.py:183-191), powers of two with a tile of
# tile_rows // SB rays that is a multiple of its 4-row interleave
# (`march_sb_ok`); K1's and K2's widths; and the most predication tiles
# one launch takes (csrc/sigmamarch.cu, slimmarch.cu, carrymarch.cu; the
# wrappers launch per range of tiles)
MARCH_SB = tuple(2 ** i for i in range(10))
# the SBs the marches took before every SB of the reference: their
# launches keep their LAUNCHES entries, the others count under "_sb"
SB_16_64 = (16, 32, 64)
SIGMA_WIDTH, SLIM_WIDTH = 128, 256
# K2's widths, with and without a view branch; narrower nets run zero-padded
# to the nearest (slimmarch.march_net), as does the σ march of a proposal
# wider or narrower than K1's SIGMA_WIDTH
SLIM_WIDTHS = (128, 256)
MARCH_MAX_TILES = 1024
# nets the field kernels K3, K4 and K6 take (csrc/wg_field.cuh): widths,
# trunk depths and posenc operand widths (x rows included: L = 6 → 48,
# 10 → 64); narrower nets are zero-padded to them (posenc_mlp.pad_packed)
FIELD_WIDTHS = (128, 256)
FIELD_DEPTHS = tuple(range(2, 9))
FIELD_K0 = (48, 64)

# rows per K4 pass: its bf16 workspace holds every activation and cotangent
# of this many rows (1.3 GB at the 8×256 field)
BWD_CHUNK_ROWS = 131072

LAUNCHES = {"field": 0, "sigma_march": 0, "slim_march": 0, "field_bwd": 0,
            "volrend": 0, "carry_march": 0, "probe_p1": 0, "probe_p2": 0,
            # the conditioned instantiations (K3's and K6's cond window, K2
            # at the halved tile, K4 with its dcond output), counted apart
            # from the unconditioned ones
            "field_cond": 0, "slim_march_cond": 0, "carry_march_cond": 0,
            "field_bwd_cond": 0,
            # K3 with the tile-skip flag (the two-stage march), K2 on a net
            # without a view branch (the generic proposal march)
            "field_alive": 0, "slim_march_novd": 0,
            # K2 serving the σ march of a proposal not K1's width
            "sigma_march_k2": 0,
            # K1, K2 and K6 at an SB outside SB_16_64
            "sigma_march_sb": 0, "slim_march_sb": 0, "carry_march_sb": 0,
            # K7, mip-NeRF 360's wide field (one a call of its entry), and
            # its training backward (one a call)
            "wide_field": 0, "wide_field_bwd": 0,
            # K8's two entries: a chunk's culling, a march's block flags
            "box_cull": 0, "block_hit": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# every entry that launches ends with (int device, void* stream): the
# ordinal of its operands' card, current for the call (fnt::DeviceGuard
# gives the thread's device back, so torch's current device stays), and a
# stream of that card (`launch_args`)
_ON_DEVICE = [_I, _P]
_SIGNATURES = {
    "fnt_field_forward": [_P] * 9 + [_I] * 10 + _ON_DEVICE,
    "fnt_sigma_march": [_P] * 13 + [_I] * 8 + _ON_DEVICE,
    "fnt_slim_march": [_P] * 16 + [_I] * 12 + [ctypes.c_float] + _ON_DEVICE,
    "fnt_field_backward": ([_P] * 20 + [ctypes.c_long] + [_I] * 12
                           + _ON_DEVICE),
    "fnt_volrend": [_P] * 8 + [_I] * 4 + _ON_DEVICE,
    "fnt_carry_march": [_P] * 17 + [_I] * 13 + [ctypes.c_float] + _ON_DEVICE,
    "fnt_tc_probe": [_P] * 3 + [_I] * 6 + _ON_DEVICE,
    "fnt_wide_field": [_P] * 11 + [_I] * 7 + _ON_DEVICE,
    "fnt_wide_field_train": [_P] * 13 + [_I] * 7 + _ON_DEVICE,
    "fnt_wide_field_backward": ([_P] * 15 + [ctypes.c_long] + [_P] * 3
                                + [_I] * 6 + _ON_DEVICE),
    "fnt_box_cull": ([_P] * 7 + [_I] * 2 + [ctypes.c_float] * 2
                     + _ON_DEVICE),
    "fnt_block_hit": ([_P] * 6 + [_I] * 4 + [ctypes.c_float] * 2
                      + _ON_DEVICE),
    # host only: the packed layout, for checking
    "fnt_layout": [_I] * 5 + [_P],
}

_lib = None
build_info: dict = {}
# set inside `plain_versions`; process-wide, not per thread, because
# autograd runs the backward of CUDA tensors on a thread of its own
_plain = False


def march_sb_ok(SB: int, tile_rows: int = TILE_ROWS) -> bool:
    """Whether the marches take SB samples a block at a predication tile
    of tile_rows rows: SB in MARCH_SB and (tile_rows // SB) % 4 == 0, the
    reference's assertion (so SB ≤ 512, or ≤ 256 at the conditioned tile
    of 1024 rows)."""
    return SB in MARCH_SB and (tile_rows // SB) % 4 == 0


def march_count(name: str, SB: int) -> str:
    """The LAUNCHES entry of a march launch at SB samples a block: `name`,
    or the kernel's "_sb" entry outside SB_16_64."""
    if SB in SB_16_64:
        return name
    kernel = ("sigma_march" if name == "sigma_march" else
              "carry_march" if name.startswith("carry_march") else
              "slim_march")
    return kernel + "_sb"


def tile_ranges(R: int, rpt: int):
    """Slices of whole tiles of rpt rays, at most MARCH_MAX_TILES a
    launch, covering R rays."""
    step = MARCH_MAX_TILES * rpt
    return [slice(r0, min(R, r0 + step)) for r0 in range(0, R, step)]


def row_ptr(t, row: int):
    """The address of row `row` of a contiguous tensor (None for None)."""
    if t is None:
        return None
    return t.data_ptr() + row * t.stride(0) * t.element_size()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfnt_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built on this host")
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one
    nvcc per source in parallel, then one link. Raises with nvcc's output
    when a step fails."""
    out = _library_path()
    if out.exists():
        if build_info.get("path") != str(out):
            build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="".join(logs))
    return out


def library() -> ctypes.CDLL:
    """The built kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fnt_error_string.argtypes = [ctypes.c_int]
        lib.fnt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@contextlib.contextmanager
def plain_versions():
    """Within the block every wrapper takes its plain version on any
    device (`on_cuda` gives None for CUDA tensors too), backwards run in
    it included. Nests; the previous state comes back on exit, also when
    the block raises."""
    global _plain
    outer, _plain = _plain, True
    try:
        yield
    finally:
        _plain = outer


def on_cuda(*tensors) -> Optional[torch.device]:
    """The CUDA device every tensor is on, or None when every one is on
    the CPU or inside `plain_versions`; raises on anything else: a
    CPU/CUDA mix, or tensors on two cards. (None entries are skipped;
    anything with a `.device` will do.)"""
    devs = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return None
    if kinds == {"cuda"}:
        if len(devs) > 1:
            raise ValueError(f"tensors on {sorted(map(str, devs))}: a kernel "
                             "launches on one card, its operands' own")
        return None if _plain else next(iter(devs))
    raise ValueError(f"tensors on devices {sorted(kinds)}: the kernels take "
                     "all-CUDA inputs, the plain versions all-CPU inputs")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the CPU is asked for
    by name. Raises when CUDA is wanted and there is none, so nothing falls
    back to the CPU silently. A CUDA device without an ordinal is torch's
    current card: in a rank, the one `dist.mesh.init_distributed` made
    current (a rank joins its group before it resolves its device)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card (pass "
                           "device cpu to run the plain versions)")
    dev = torch.device(device or "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check(t, name: str, dtype, shape) -> None:
    """Raise unless t has this dtype, this shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch_args(dev: torch.device) -> tuple:
    """The last two arguments of every launching entry: the card's ordinal
    and its current stream (of that card, not of torch's current device)."""
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def raise_on_error(code: int, name: str) -> None:
    if code != 0:
        msg = library().fnt_error_string(code).decode()
        raise RuntimeError(f"{name}: launch failed with cudaError {code} "
                           f"({msg})")
