#!/usr/bin/env python3
"""Profiles the proposal distillation on the card.

    python scripts/torch_distill_profile.py [--steps 100]

Distils a proposal from the committed flagship fine net
(`models/proposal.py::attach_proposal` with `use_asset=False`) under
torch.profiler, once through the fused field (K3 for the teacher, K3 + K4
for the student) and once with `kernels.use_pallas=false` (the plain
modules), after a warm-up run of each. Prints the host and the device time
of the profiled run, the host op calls and the kernel launches a step, and
the ops that take most of the host time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import committed_state  # noqa: E402  (puts src on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    from fashion_nerf_torch import kernels as K
    from fashion_nerf_torch.config import load_config
    from fashion_nerf_torch.models import proposal
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the distillation is profiled "
                           "on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    K.library()
    torch.set_grad_enabled(False)
    for ovr in ([], ["kernels.use_pallas=false"]):
        cfg = load_config("blender_lego",
                          [f"proposal.distill_steps={args.steps}"] + ovr)
        state, _ = committed_state(cfg, dev)
        params = {"fine": state.fine}
        proposal.attach_proposal(cfg, params, use_asset=False)    # warm-up
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            proposal.attach_proposal(cfg, params, use_asset=False)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        host = sum(e.self_cpu_time_total for e in ev) / 1e3
        # device entries (kernels, copies) carry no host time of their own
        device = sum(e.self_device_time_total for e in ev
                     if e.self_cpu_time_total == 0) / 1e3
        calls = sum(e.count for e in ev if e.self_cpu_time_total > 0)
        launches = sum(e.count for e in ev if "LaunchKernel" in e.key)
        print(f"==== {ovr or 'the fused field'}: {args.steps} steps, host "
              f"{host:.1f} ms, device {device:.1f} ms, {calls / args.steps:.0f}"
              f" host op calls and {launches / args.steps:.0f} launches a "
              f"step; {smi}")
        print(ev.table(sort_by="self_cpu_time_total", row_limit=12,
                       max_name_column_width=48))
    return 0


if __name__ == "__main__":
    sys.exit(main())
