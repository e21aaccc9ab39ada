"""The harness: one run of one cell, from BENCHMARK.json and its files.

Order of a run: find the cell and its configuration and traffic files;
set up the program (its phases printed on standard error, from process
start); warm the cell's shapes; the measured window, closed loop, for
--seconds (traced with torch.profiler under --trace 1); the device's
peak memory; the check that no JAX module was loaded; the program's
state freed; the driver's comparison with the reference (and, traced,
the work each unit of the window needed); the
metrics, each from its reader perfbench/metrics/<name>.py; the numbers
compared beside their limits (perfbench/checks/<cell>.json), last on
standard error and last in the result line, which is the last line of
standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

from perfbench import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "fashion_nerf")


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its documents resolved."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @classmethod
    def load(cls, name: str, manifest: dict = None) -> "Cell":
        bench = manifest or load_json("BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[
            w["config"]]

        def here(m):
            return "workloads" not in m or name in m["workloads"]

        checks = load_json(f"perfbench/checks/{name}.json")
        return cls(name=name, chips=w["chips"], config=load_json(cfg_file),
                   traffic=load_json(f"perfbench/traffic/{w['traffic']}"
                                     ".json"),
                   end_to_end=[m for m in bench["end_to_end"] if here(m)],
                   per_layer=[m for m in bench["per_layer"] if here(m)],
                   limits=checks["limits"])


@dataclass
class Record:
    """What a run measured, for the metric readers."""
    setup_s: float = 0.0
    window_s: float = 0.0
    unit_s: list = field(default_factory=list)      # wall time per unit
    unit_work: list = field(default_factory=list)   # rays per unit
    trace: object = None                            # devtrace.DeviceTrace
    counts: list = field(default_factory=list)      # reference, per unit
    flops: dict = field(default_factory=dict)       # per evaluation, by net
    budget: tuple = (0, 0)                          # evaluations a ray


def reader(metric: str):
    """The `read(record)` of perfbench/metrics/<metric>.py."""
    path = os.path.join(ROOT, "perfbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(traffic: dict):
    return importlib.import_module(
        f"perfbench.drivers.{traffic['driver']}").Driver


def say(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, traffic_overrides: dict = None,
             numbers_out: dict = None) -> dict:
    """One run → the result dict (without printing it). traffic_overrides:
    top-level keys replaced in the traffic document (the tests' small
    frames); numbers_out: filled with every number the driver compares,
    with or without a limit (the calibration's). `attempted` counts the
    window's units (each completes, or the run stops with an error);
    `failed` the numbers compared that are over their limit."""
    import torch
    traffic = dict(cell.traffic, **(traffic_overrides or {}))
    last = [t_start]

    def timer(phase: str) -> None:
        now = time.perf_counter()
        say(f"set-up {phase}: {now - last[0]:.3f} s")
        last[0] = now

    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    drv = driver_class(traffic)(cell.config, traffic, seed, device, say)
    drv.setup(timer)
    drv.warm(timer)
    rec = Record()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    from torch.profiler import record_function
    from perfbench.devtrace import WINDOW_SPAN
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    say(f"set-up total (process start to the window): {rec.setup_s:.3f} s")
    with record_function(WINDOW_SPAN):
        k, t = 0, t0
        while t - t0 < seconds:
            with record_function(drv.unit_span):
                work = drv.unit(k)
            now = time.perf_counter()
            rec.unit_s.append(now - t)
            rec.unit_work.append(work)
            k, t = k + 1, now
    rec.window_s = t - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    u = sorted(rec.unit_s)
    say(f"window: {k} units in {rec.window_s:.3f} s; a unit's seconds: "
        f"min {u[0]:.4f} median {u[len(u) // 2]:.4f} max {u[-1]:.4f}")
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": (
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)}
    _no_jax()
    breakdown = None
    if prof is not None:
        from perfbench import devtrace
        t1 = time.perf_counter()
        rec.trace = devtrace.collect(prof, drv.unit_span,
                                     getattr(drv, "watch", ()))
        prof = None
        device_info.update(busy_s=rec.trace.busy_s,
                           window_s=rec.trace.window_s)
        breakdown = rec.trace.breakdown()
        say(f"trace read in {time.perf_counter() - t1:.3f} s: busy "
            f"{rec.trace.busy_s:.3f} s of {rec.trace.window_s:.3f} s")
    drv.release()
    t1 = time.perf_counter()
    numbers = drv.check(trace)
    say(f"reference in {time.perf_counter() - t1:.3f} s")
    if numbers_out is not None:
        numbers_out.update(numbers)
    for name, value in numbers.items():
        if name not in cell.limits:
            say(f"reading {name}: {value!r} (no limit: not compared)")
    if trace:
        rec.counts = drv.counts
        rec.flops, rec.budget = drv.flops(), drv.budget()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    for name, value in numbers.items():
        if name in cell.limits:
            checks[name] = {"value": value, "limit": cell.limits[name]}
    missing = sorted(set(cell.limits) - set(checks))
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    correct = bool(checks) and not missing and failed == 0
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    result = {"correct": correct, "attempted": len(rec.unit_s),
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    _no_jax()
    return result


class ForbiddenModules(RuntimeError):
    pass


def _no_jax() -> None:
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(", ".join(bad))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = Cell.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start)
    except ForbiddenModules as e:
        say(f"modules of JAX or of the JAX package were loaded: {e}")
        return 3
    print(json.dumps(result), flush=True)
    return 0
