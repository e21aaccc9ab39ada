"""Command line of the port; counterpart of `fashion_nerf.cli`.

    python -m fashion_nerf_torch {train,render,eval,bench,parity}
        --config NAME [--set k=v ...] [--out DIR] [--resume]
        [--profile] [--sanitize] [--device cuda|cpu]

- `train` trains, logging one JSON line per log step, and ends with a JSON
  summary line. Checkpoints go to DIR/NAME/ckpt. Started by
  `python -m torch.distributed.run --nproc_per_node N -m fashion_nerf_torch
  train --set dist.dp=N ...`, the N ranks train one run (`dist.dp`,
  `dist.tp`; `dist.mesh`).
- `eval` restores the latest checkpoint, renders the test views (the
  held-out view where the dataset has no test split) and prints one JSON
  line: psnr, ssim, n_views and, for a real scene, its anchor row.
- `render` restores it, renders the dataset's path of poses and writes
  DIR/NAME/render/000.png ... and, where `imageio` can, video.mp4.
- `parity` evaluates every scene directory under data.root against its
  published anchor, from the checkpoints at DIR/<scene>/NAME/ckpt.
- `bench` prints the render benchmark's JSON (`bench.run_bench`).
- `preprocess` runs the try-on preprocessing over every pair under
  data.root (or the procedural pair) and writes DIR/NAME/preprocess/
  <id>_{agnostic,warped_cloth,tryon_overlay}.png and <id>_cond.npy.

`render` and `eval` sweep the occupancy grid of the fine field, attach the
proposal net (the committed asset, or one distilled here) and render
through the blockwise fast path when the config takes it
(`config.takes_blockwise`), otherwise through the dense renderer. A
conditioned config (the try-on presets) renders with the scene's cond
vector: the garment code of its conditioning stack ⊕, for `dynamic_tryon`,
a per-frame latent; the sweep and the proposal take frame 0's cond, which
every frame of a dynamic render shares (latent i % n_latents for frame i),
as the reference does. `train` of a conditioned config trains the garment
encoder and the latent table with the fields. Everything runs on the CUDA
device and raises when there is none, unless `--device cpu` asks for the
CPU, where every kernel takes its plain version. The resolved config is
written to DIR/NAME/config.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Optional

SUBCOMMANDS = ("train", "render", "eval", "preprocess", "bench", "parity")


def _parser():
    p = argparse.ArgumentParser(prog="fashion-nerf-torch",
                                description="NeRF + try-on on one CUDA "
                                "device")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in SUBCOMMANDS:
        sp = sub.add_parser(name)
        sp.add_argument("--config", default="tiny_lego",
                        help="preset name (fashion_nerf_torch.config."
                             "PRESETS)")
        sp.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="k=v",
                        help="dotted config override")
        sp.add_argument("--out", default=None, help="run directory")
        sp.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
        sp.add_argument("--profile", action="store_true",
                        help="wrap the run in torch.profiler and write a "
                             "trace under the run directory")
        sp.add_argument("--sanitize", action="store_true",
                        help="torch.autograd.set_detect_anomaly")
        sp.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain "
                             "versions; no CUDA device and no --device cpu "
                             "raises)")
    return p


def main(argv=None, dataset: Optional[dict] = None) -> int:
    """Run one subcommand. dataset: a loaded dataset dict in place of the
    one `cfg.data` names, for a caller that runs several subcommands on one
    scene in one process."""
    args = _parser().parse_args(argv)
    import torch
    from fashion_nerf_torch.config import config_to_dict, load_config
    from fashion_nerf_torch.kernels import resolve_device
    cfg = load_config(args.config, args.overrides)
    if args.out:
        # --out is the run directory of every subcommand: checkpoints live
        # under <out>/<config>/ckpt, render writes <out>/<config>/render
        cfg = dataclasses.replace(cfg, out_dir=args.out)
    # train resolves its device once it has joined its group (`_cmd_train`)
    device = None if args.cmd == "train" else resolve_device(args.device)
    if args.sanitize:
        torch.autograd.set_detect_anomaly(True)

    run_dir = os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.json")
    tmp = f"{path}.{os.getpid()}.tmp"      # the ranks of a run write it too
    with open(tmp, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
    os.replace(tmp, path)

    with (_profiler(run_dir) if args.profile else contextlib.nullcontext()):
        if args.cmd == "train":
            return _cmd_train(cfg, args, dataset)
        with torch.no_grad():
            if args.cmd == "render":
                return _cmd_render(cfg, device, dataset)
            if args.cmd == "eval":
                return _cmd_eval(cfg, device, dataset)
            if args.cmd == "bench":
                return _cmd_bench(cfg, device)
            if args.cmd == "preprocess":
                from fashion_nerf_torch.tryon.pipeline import preprocess_cli
                return preprocess_cli(cfg, device)
            return _cmd_parity(cfg, device, dataset)


@contextlib.contextmanager
def _profiler(run_dir: str):
    """torch.profiler over the run; the chrome trace goes to
    <run_dir>/trace/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.join(run_dir, "trace"), exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(run_dir, "trace", "trace.json"))


def _cmd_train(cfg, args, dataset):
    """Train; under `python -m torch.distributed.run --nproc_per_node N`
    the ranks join one process group, cfg.dist names the mesh (its
    `{"mesh": …}` line goes to stderr) and rank 0 alone logs and prints the
    summary. A group the caller already joined is used and left up. The
    device is resolved after the join: a rank's is its card."""
    import torch
    from fashion_nerf_torch.dist import mesh as dmesh
    from fashion_nerf_torch.kernels import resolve_device
    from fashion_nerf_torch.train.loop import train
    joins = not torch.distributed.is_initialized()
    backend = dmesh.init_distributed(cfg.dist.multihost, device=args.device)
    device = resolve_device(args.device)
    mesh = dmesh.resolve_mesh(cfg.dist)
    if mesh is not None:
        print(json.dumps(dmesh.describe(mesh, backend, device)),
              file=sys.stderr, flush=True)
    main = dmesh.is_main()
    try:
        with torch.enable_grad():
            state, history = train(cfg, dataset_dict=dataset,
                                   resume=args.resume, device=device,
                                   mesh=mesh)
    finally:
        if joins and backend is not None:
            dmesh.shutdown_distributed()
    if main:
        print(json.dumps({"done": True, "steps": state.step,
                          "final": history[-1] if history else None}))
    return 0


def _restored_state(cfg, device):
    """The latest checkpoint of the run, restored into a fresh state on
    `device` (a checkpoint written on either kind of device)."""
    from fashion_nerf_torch import ckpt as ckpt_lib
    from fashion_nerf_torch.prng import GeneratorChain
    from fashion_nerf_torch.train.state import create_train_state
    chain = GeneratorChain(cfg.train.seed)
    tmpl = create_train_state(cfg, chain.once("init"),
                              chain.once("run", device), device)
    return ckpt_lib.restore(os.path.join(cfg.out_dir, cfg.name, "ckpt"), tmpl)


def _blockwise_render_fn(cfg, params, H, W, focal, occ, device):
    """The fast path for whole-image renders, (pose, cond vector or None)
    → output dict: the blockwise early-terminated march that the bench
    measures. None when the config is not eligible (kernels off or
    coarse-only): the dense renderer serves then."""
    from fashion_nerf_torch.config import asks_blockwise, takes_blockwise
    if not takes_blockwise(cfg):
        if asks_blockwise(cfg):
            # the fast path was asked for and the config excludes it
            print("fashion-nerf-torch: blockwise fast path ineligible for "
                  "this config (coarse-only or fused_mlp off); using the "
                  "dense renderer", file=sys.stderr)
        return None
    from fashion_nerf_torch.render.blockwise import render_image_blockwise
    return lambda pose, cond=None: render_image_blockwise(
        params, cfg, H, W, focal, pose, occ=occ, device=device, cond=cond)


def _with_proposal(cfg, params, occ, device, cond=None):
    """`params` with the σ-only proposal net attached (the asset, or one
    distilled for these weights, with a conditioned teacher run at the
    scene's cond vector); unchanged unless proposal.enabled and the
    blockwise fast path is eligible."""
    from fashion_nerf_torch.config import takes_blockwise
    if not (takes_blockwise(cfg) and cfg.proposal.enabled):
        return params
    from fashion_nerf_torch.models.proposal import attach_proposal
    return attach_proposal(cfg, params, occ=occ, cond=cond, device=device)


def _maybe_occ(cfg, field, net, device, cond=None):
    """Occupancy culling state of a restored model, whenever the config
    enables it: the grid means something only on trained weights. A
    conditioned field is swept at the scene's cond vector."""
    if not cfg.occupancy.enabled:
        return None
    from fashion_nerf_torch.core.occupancy import build_from_config
    return build_from_config(cfg, lambda p, v, *c: field(net, p, v, *c),
                             device=device, cond=cond)


def _setup(cfg, device, dataset):
    """Restore the run and prepare its renders → (dataset dict, renderer
    (pose, cond=frame 0's) → output dict, dense, frame_cond). The renderer
    is the blockwise fast path (dense is None) or, when the config is not
    eligible, `render_image` (dense holds its arguments, for
    `render_path`). frame_cond(i) is frame i's cond vector (None for an
    unconditioned config)."""
    from fashion_nerf_torch.config import is_mipnerf360
    from fashion_nerf_torch.render.renderer import render_image
    from fashion_nerf_torch.kernels.posenc_mlp import field_for
    from fashion_nerf_torch.train.loop import (_eval_cond, load_dataset,
                                               resolve_garment)
    state = _restored_state(cfg, device)
    d = load_dataset(cfg, device) if dataset is None else dataset
    H, W, focal = int(d["H"]), int(d["W"]), float(d["focal"])
    nets = state.nets()
    if is_mipnerf360(cfg):
        # mip-NeRF 360's nets: no occupancy, no distillation, its own chunks
        from fashion_nerf_torch.render.blockwise import (
            render_image_blockwise)
        return (d, (lambda pose, c=None: render_image_blockwise(
            nets, cfg, H, W, focal, pose, device=device)), None,
            lambda i: None)
    garment = resolve_garment(cfg, d, H, W, device)

    def frame_cond(i):
        return _eval_cond(cfg, nets, garment,
                          frame_id=i % max(cfg.model.n_latents, 1))

    cond = frame_cond(0)
    field = field_for(cfg)
    use_fine = cfg.sampling.n_fine > 0 and state.fine is not None
    occ = _maybe_occ(cfg, field, state.fine if use_fine else state.coarse,
                     device, cond)
    params = _with_proposal(cfg, nets, occ, device, cond)
    bw = _blockwise_render_fn(cfg, params, H, W, focal, occ, device)
    if bw is not None:
        return d, (lambda pose, c=cond: bw(pose, c)), None, frame_cond
    fc = (lambda pts, vd, *c: field(state.coarse, pts, vd, *c))
    ff = ((lambda pts, vd, *c: field(state.fine, pts, vd, *c)) if use_fine
          else None)
    dense = dict(field_coarse=fc, field_fine=ff, H=H, W=W, focal=focal,
                 cfg=cfg, occ=occ, device=device)
    return (d, (lambda pose, c=cond: render_image(c2w=pose, cond=c, **dense)),
            {**dense, "cond": cond}, frame_cond)


def _cmd_render(cfg, device, dataset):
    import numpy as np
    from fashion_nerf_torch.png import write_png
    from fashion_nerf_torch.render.renderer import render_path
    d, render, dense, frame_cond = _setup(cfg, device, dataset)
    poses = d.get("render_poses", d["poses"])
    t0 = time.perf_counter()
    secs = []
    if dense is None or cfg.model.n_latents > 0:
        # a dynamic render takes frame i's latent i % n_latents
        frames = []
        for i, pose in enumerate(poses):
            t1 = time.perf_counter()
            out = (render(pose, frame_cond(i)) if cfg.model.n_latents > 0
                   else render(pose))
            frames.append(out["rgb"].cpu())     # waits for the frame
            secs.append(time.perf_counter() - t1)
        arr = np.stack([f.numpy() for f in frames])
    else:
        arr = render_path(poses=poses, **dense).cpu().numpy()
    total = time.perf_counter() - t0
    spread = (f"; seconds a frame min {min(secs):.4f}, median "
              f"{statistics.median(secs):.4f}, max {max(secs):.4f}"
              if secs else "")
    print(f"fashion-nerf-torch: {len(arr)} frames of {arr.shape[2]}x"
          f"{arr.shape[1]} rendered in {total:.3f} s on {device.type}"
          f"{spread}", file=sys.stderr)
    out = os.path.join(cfg.out_dir, cfg.name, "render")
    os.makedirs(out, exist_ok=True)
    arr8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    for i, fr in enumerate(arr8):
        write_png(os.path.join(out, f"{i:03d}.png"), fr)
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(os.path.join(out, "video.mp4"), arr8, fps=24)
    except (ImportError, ValueError, RuntimeError, OSError) as e:
        # no imageio, or no mp4 writer behind it; the PNGs are written
        print(f"(video skipped: {e})", file=sys.stderr)
    print(json.dumps({"frames": len(arr8), "out": out}))
    return 0


def eval_views(cfg, device, dataset=None):
    """Restore the run's checkpoint and render its test views → ([(psnr,
    ssim) per view], [rgb (H, W, 3) per view]). The hermetic scenes have no
    test split: their held-out view stands in."""
    import numpy as np
    import torch
    from fashion_nerf_torch.metrics import psnr, ssim
    d, render, _, _ = _setup(cfg, device, dataset)
    test_images = d.get("test_images", np.asarray(d["val_image"])[None])
    test_poses = d.get("test_poses", np.asarray(d["val_pose"])[None])
    scores, frames = [], []
    for img, pose in zip(test_images, test_poses):
        rgb = render(pose)["rgb"]
        ref = torch.as_tensor(np.asarray(img), dtype=torch.float32,
                              device=rgb.device)
        scores.append((float(psnr(rgb, ref)), float(ssim(rgb, ref))))
        frames.append(rgb)
    return scores, frames


def _eval_scores(cfg, device, dataset=None):
    """→ (mean psnr, mean ssim, n views); shared by eval and parity."""
    scores, _ = eval_views(cfg, device, dataset)
    n = len(scores)
    return (sum(s[0] for s in scores) / n, sum(s[1] for s in scores) / n, n)


def _cmd_eval(cfg, device, dataset):
    from fashion_nerf_torch.parity import anchor_row
    mean_psnr, mean_ssim, n = _eval_scores(cfg, device, dataset)
    row = {"psnr": mean_psnr, "ssim": mean_ssim, "n_views": n}
    if cfg.data.root:
        row.update(anchor_row(cfg.data.root, cfg.data.dataset, mean_psnr))
    print(json.dumps(row))
    return 0


def _cmd_parity(cfg, device, dataset):
    """Per-scene PSNR/SSIM against the anchors over every scene directory
    under data.root, from the per-scene checkpoints at
    <out>/<scene>/<config>/ckpt (the layout `train --out <out>/<scene>`
    produces). Exit code 1 when no scene was found."""
    from fashion_nerf_torch.parity import run_parity

    def eval_scene(scene_cfg):
        scene = os.path.basename(os.path.normpath(scene_cfg.data.root))
        scene_cfg = dataclasses.replace(
            scene_cfg, out_dir=os.path.join(cfg.out_dir, scene))
        p, s, _ = _eval_scores(scene_cfg, device, dataset)
        return p, s

    return 0 if run_parity(cfg, eval_scene) else 1


def _cmd_bench(cfg, device):
    from fashion_nerf_torch.bench import run_bench
    print(json.dumps(run_bench(cfg, device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
