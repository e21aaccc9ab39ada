"""Command line of the port; counterpart of `fashion_nerf.cli`.

    python -m fashion_nerf_torch.cli train --config NAME [--set k=v ...]
        [--out DIR] [--resume] [--device cuda|cpu]

trains on the CUDA device, logging one JSON line per log step, and ends
with a JSON summary line. It raises when there is no CUDA device unless
`--device cpu` asks for the CPU, where every kernel takes its plain
version. Checkpoints go to
DIR/NAME/ckpt. The reference's other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

_NOT_PORTED = {
    "render": "ROADMAP Queue 1 #10",
    "eval": "ROADMAP Queue 1 #10",
    "preprocess": "ROADMAP Queue 1 #11",
    "bench": "ROADMAP Queue 1 #7: run python -m fashion_nerf_torch.bench",
    "parity": "ROADMAP Queue 1 #10",
}


def _parser():
    p = argparse.ArgumentParser(prog="fashion-nerf-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("train", *_NOT_PORTED):
        sp = sub.add_parser(name)
        sp.add_argument("--config", default="tiny_lego")
        sp.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="k=v")
        sp.add_argument("--out", default=None, help="run directory")
        sp.add_argument("--resume", action="store_true")
        sp.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain "
                             "versions; no CUDA device and no --device cpu "
                             "raises)")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd in _NOT_PORTED:
        raise NotImplementedError(f"`{args.cmd}` is not ported yet "
                                  f"({_NOT_PORTED[args.cmd]})")
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.train.loop import train
    cfg = load_config(args.config, args.overrides)
    if args.out:
        cfg = dataclasses.replace(cfg, out_dir=args.out)
    state, history = train(cfg, resume=args.resume, device=args.device)
    print(json.dumps({"done": True, "steps": state.step,
                      "final": history[-1] if history else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
