#!/usr/bin/env python3
"""The readings the limits of a cell's comparison are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 3] [--check-frames N] [--control-seeds 4,5,6] \
        [--fault altered|half|stale] [--out FILE]

Program: one short run of the cell per seed, in this process, through the
harness (set-up, warm-up, a window of --seconds, the comparison), and its
numbers, limits or none; with --fault, with that fault planted under the
program (perfbench/faults.py). Control: the reference computed with
float8 e4m3 products (perfbench/reference/, quant "fp8") put in the
program's place at the cell's own size, on the frames or the first steps
each control seed draws, held against the float32 reference. The
benchmark's own runs never run the control. Prints one line per reading
and a JSON summary last.
"""

import argparse
import contextlib
import json
import os
import sys
import time

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers for one seed: the fp8 reference in the
    program's place, at the cell's size (`Driver.control`)."""
    drv = harness.driver_class(cell.traffic)(cell.config, cell.traffic, seed,
                                             device, harness.say)
    return drv.control("fp8")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--check-frames", type=int, default=None,
                   help="compare this many frames a program run")
    p.add_argument("--fault", default=None,
                   help="run the program seeds with this fault planted "
                   "(perfbench/faults.py)")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        harness.say("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "program": {}, "control": {}}
    plant = contextlib.nullcontext
    if args.fault:
        plant = faults.FAULTS[cell.traffic["driver"]][args.fault]
        out["fault"] = args.fault
    for s in seeds:
        numbers = {}
        over = ({} if args.check_frames is None
                else {"check_frames": args.check_frames})
        with plant():
            r = harness.run_cell(cell, s, args.seconds, False, device,
                                 time.perf_counter(), traffic_overrides=over,
                                 numbers_out=numbers)
        out["program"][s] = numbers
        print(f"program seed {s}: {json.dumps(numbers)} "
              f"frames {r['attempted']} metrics {json.dumps(r['metrics'])}",
              flush=True)
    for s in cseeds:
        numbers = control_numbers(cell, s, device)
        out["control"][s] = numbers
        print(f"control seed {s}: {json.dumps(numbers)}", flush=True)
    for side in ("program", "control"):
        vals = out[side]
        if vals:
            keys = next(iter(vals.values())).keys()
            out[side + "_range"] = {
                k: [min(v[k] for v in vals.values()),
                    max(v[k] for v in vals.values())] for k in keys}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
