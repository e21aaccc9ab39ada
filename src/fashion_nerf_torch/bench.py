"""Render benchmark of the port: rays/s of one 800×800 frame of a preset on
one CUDA device. Counterpart of `fashion_nerf.bench.run_bench`; it prints
the same JSON keys.

Setup (outside the timed loop), as the reference's `_bench_params` and
`run_bench` choose it (`bench_setup`): the committed trained flagship
weights when they were trained for this config (the asset's config name
and the parameter tree match), else the seeded random init; the 64³
occupancy sweep of the field through kernel K3 only when the config
enables occupancy and the weights are trained; the committed σ-only
proposal net only when the config enables it, the weights are trained and
the render is blockwise. Frame: `render_image_blockwise` (K1 and K2 for
`blender_lego`, the two-stage march through K3 for `llff_fern`), or the
dense renderer when the config is not eligible for the blockwise path.
Run as `python -m fashion_nerf_torch.bench [--config NAME]`.

Training mode (`bench_train`, the reference's `bench_train`): steady-state
training rays/s (forward, backward and Adam) of `TrainStep` on an 8-view
64×64 synthetic scene, the rays resident on the device, 10 warm-up and 50
timed steps between two synchronizes. Run as `python -m
fashion_nerf_torch.bench --train [--config NAME] [--device cpu]`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from fashion_nerf_torch.assets import _flatten, load_flagship
from fashion_nerf_torch.config import (Config, load_config, takes_blockwise,
                                       takes_fused_render)
from fashion_nerf_torch import kernels as K
from fashion_nerf_torch.core.occupancy import build_from_config
from fashion_nerf_torch.data.pipeline import RayDataset
from fashion_nerf_torch.data.synthetic import make_synthetic_scene
from fashion_nerf_torch.kernels.posenc_mlp import field_for
from fashion_nerf_torch.models.nerf_mlp import NeRFMLP, load_flax_params
from fashion_nerf_torch.models.proposal import attach_proposal
from fashion_nerf_torch.prng import GeneratorChain
from fashion_nerf_torch.render.blockwise import (_budgets,
                                                 fine_march_samples,
                                                 render_image_blockwise)
from fashion_nerf_torch.render.renderer import render_image
from fashion_nerf_torch.train.loop import (TrainStep, _eval_cond,
                                           resolve_garment)
from fashion_nerf_torch.train.state import create_train_state


def bench_pose(W: int):
    """Focal and camera-to-world of the reference bench: blender-standard
    fov, camera at z = 4 looking down −z."""
    focal = 0.5 * W / np.tan(0.5 * 0.6911)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return float(focal), c2w


def _shapes(nets: dict) -> dict:
    """{net: {key path: shape}} of NeRFMLPs or of the reference's trees."""
    return {k: {p: v.shape for p, v in _flatten(
        n.to_flax_params() if isinstance(n, NeRFMLP) else n).items()}
            for k, n in nets.items()}


def bench_params(cfg: Config, device) -> tuple:
    """→ (nets, trained): the committed flagship weights when the asset was
    trained for cfg (its meta config is cfg.name, and its parameter tree
    is the one cfg builds), else the random init of seed cfg.train.seed.
    Weights matter: culling and early termination are invisible at random
    init."""
    chain = GeneratorChain(cfg.train.seed)
    state = create_train_state(cfg, chain.once("init"),
                               chain.once("run", device), device)
    nets = {k: v for k, v in state.nets().items() if v is not None}
    loaded = load_flagship()
    if loaded is None:
        return nets, False
    trained, meta = loaded
    if (str(meta.get("config", "")) != cfg.name
            or set(nets) != set(trained)
            or _shapes(nets) != _shapes(trained)):
        return nets, False
    return {k: load_flax_params(trained[k],
                                compute_dtype=cfg.model.compute_dtype,
                                device=device) for k in trained}, True


def bench_setup(cfg: Config, device) -> dict:
    """The bench's choice of what it renders, on any device → dict params
    (the nets, with "proposal" when attached), trained, occ (or None),
    cond (the per-scene cond vector, or None), blockwise. Raises when the
    config is trained and takes a proposal but the committed asset does
    not match: the bench measures that pair and does not distil a
    stand-in."""
    params, trained = bench_params(cfg, device)
    garment = resolve_garment(cfg, {}, 64, 64, device)
    cond = _eval_cond(cfg, params, garment)
    blockwise = takes_blockwise(cfg)
    occ = None
    if cfg.occupancy.enabled and trained:
        name = "fine" if "fine" in params else "coarse"
        field = field_for(cfg)
        occ = build_from_config(
            cfg, lambda p, v, *c: field(params[name], p, v, *c),
            device=device, cond=cond)
    if blockwise and cfg.proposal.enabled and trained:
        params = attach_proposal(cfg, params, allow_distill=False,
                                 device=device)
        if cfg.sampling.n_fine > 0 and "proposal" not in params:
            raise FileNotFoundError(
                "assets/proposal_synthetic.npz is missing or was not "
                "distilled for the committed flagship weights and this "
                "config")
    return {"params": params, "trained": trained, "occ": occ, "cond": cond,
            "blockwise": blockwise}


def setup(cfg: Config, device):
    """→ (params, occ, setup seconds) of `bench_setup`."""
    t0 = time.perf_counter()
    s = bench_setup(cfg, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return s["params"], s["occ"], time.perf_counter() - t0


def _budget(cfg: Config, s: dict) -> str:
    """The per-ray evaluation budget of the frame, as the reference words
    it."""
    if s["blockwise"] and "proposal" in s["params"]:
        n_p = _budgets(cfg, s["occ"])[0]
        return (f"{fine_march_samples(cfg, s['occ'])} full-MLP + {n_p} "
                "proposal-MLP evals/ray")
    n_c, n_f = cfg.sampling.n_coarse, cfg.sampling.n_fine
    if s["blockwise"] and s["occ"] is not None and (
            cfg.render.eval_n_coarse or cfg.render.eval_n_fine):
        n_c = cfg.render.eval_n_coarse or n_c
        n_f = (cfg.render.eval_n_fine or n_f) if n_f > 0 else 0
    return f"{n_c + (n_c + n_f if n_f > 0 else 0)} field evals/ray"


def run_bench(cfg: Config, device="cuda", H: int = 800, W: int = 800,
              warmup: int = 1, iters: int = 3) -> dict:
    """Render H×W as `bench_setup` chooses; report rays/sec on this card."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_bench needs a CUDA device; none is available")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"run_bench runs on a CUDA device, not {device}")
    t0 = time.perf_counter()
    s = bench_setup(cfg, device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    params, occ, cond = s["params"], s["occ"], s["cond"]
    focal, c2w = bench_pose(W)
    if s["blockwise"]:
        def render():
            return render_image_blockwise(params, cfg, H, W, focal, c2w,
                                          occ=occ, device=device, cond=cond)
    else:
        field = field_for(cfg)
        fine = params.get("fine")

        def render():
            return render_image(
                lambda p, v, *c: field(params["coarse"], p, v, *c),
                None if fine is None else
                (lambda p, v, *c: field(fine, p, v, *c)),
                H, W, focal, c2w, cfg, occ=occ, device=device, cond=cond,
                use_fused_render=takes_fused_render(cfg))

    with torch.no_grad():
        for _ in range(warmup):
            render()
        K.reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            render()
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    return {
        "metric": ("rays/sec/chip at 800x800 render (coarse+fine, "
                   f"{_budget(cfg, s)})"),
        "value": round(H * W / dt, 1),
        "unit": "rays/sec",
        # the port has no baseline of its own yet (PERF.md holds its first
        # numbers); the reference's ratio is not carried over
        "vs_baseline": None,
        "frame_seconds": round(dt, 4),
        "config": cfg.name,
        "pallas": False,
        "kernels": "cuda-sm90a",
        "blockwise": s["blockwise"],
        "trained_ckpt": s["trained"],
        "proposal": s["blockwise"] and "proposal" in params,
        "occupancy_cull": occ is not None,
        "setup_seconds": round(setup_s, 3),
        "launches_per_frame": {k: v / iters for k, v in K.LAUNCHES.items()},
        "device": torch.cuda.get_device_name(device),
    }


def power_limit():
    """The card's power limit as nvidia-smi prints it ("700.00 W"), or None
    where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def bench_train(cfg: Config, steps: int = 50, warmup: int = 10,
                device="cuda") -> dict:
    """Steady-state training throughput: rays/s of `TrainStep` (forward,
    backward and Adam) on the reference's recipe, an 8-view 64×64 synthetic
    scene whose rays stay on the device, the state drawn from seed 0 as the
    reference's PRNGKey(0). One synchronize after the warm-up steps and one
    after the timed ones. device: CUDA, or the CPU when asked for by name
    (`kernels.resolve_device`)."""
    device = K.resolve_device(device)
    scene = make_synthetic_scene(n_views=8, H=64, W=64, n_samples=32)
    ds = RayDataset(scene["images"], scene["poses"], scene["focal"],
                    device=device)
    chain = GeneratorChain(0)
    state = create_train_state(cfg, chain.once("init"),
                               chain.once("run", device), device)
    step = TrainStep(cfg, ds, garment=resolve_garment(cfg, scene, ds.H,
                                                      ds.W, device))
    all_rays = ds.batch_arrays()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        state, _ = step(state, all_rays)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, all_rays)
    sync()
    dt = (time.perf_counter() - t0) / steps
    on_card = device.type == "cuda"
    return {
        "metric": "train rays/sec/chip (fwd+bwd+adam)",
        "value": round(cfg.train.batch_rays / dt, 1),
        "unit": "rays/sec",
        "step_ms": round(dt * 1e3, 3),
        "config": cfg.name,
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "power_limit": power_limit() if on_card else None,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m fashion_nerf_torch.bench")
    p.add_argument("--config", default="blender_lego")
    p.add_argument("--train", action="store_true",
                   help="training rays/s (bench_train) in place of the "
                   "render frame")
    p.add_argument("--device", default=None,
                   help="with --train: cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    if args.train:
        print(json.dumps(bench_train(cfg, device=args.device)))
    else:
        print(json.dumps(run_bench(cfg)))


if __name__ == "__main__":
    main()
