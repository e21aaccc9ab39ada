"""Device time from a torch.profiler trace of the measured window.

`collect` turns the profiler's raw events into a `DeviceTrace`: the
device operations (kernels, copies, sets) with their times, the union of
their intervals (busy seconds), the time each operation name took, and
the idle gaps between device operations named by what the host was doing
then: the harness's span around the unit and the innermost host operation
open at the gap's midpoint ("frame/aten::nonzero").
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

WINDOW_SPAN = "perfbench.window"


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)     # name → device seconds
    gaps: dict = field(default_factory=dict)    # host activity → seconds
    # host span → device seconds of the operations launched inside it
    under: dict = field(default_factory=dict)

    def seconds(self, patterns, exclude=()) -> float:
        """Device seconds of the operations whose name holds one of
        patterns and none of exclude."""
        return sum(s for n, s in self.ops.items()
                   if any(p in n for p in patterns)
                   and not any(x in n for x in exclude))

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _call(e, name: str, default=0):
    f = getattr(e, name, None)
    return f() if f is not None else default


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns, correlation) of every event:
    the profiler's raw kineto events where this torch has them, else its
    FunctionEvents (slow: they are built one by one). The correlation is
    the launch call's id on a device event and on that call's host event
    (0 where this torch gives none). The device-side copies of the
    host's annotations (`record_function` ranges mirrored onto the device
    timeline, named as the host range is) are left out: they are no
    device work."""
    from torch.autograd import DeviceType
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raw = [(e.name, e.device_type != DeviceType.CPU,
                int(e.time_range.start * 1e3), int(e.time_range.end * 1e3),
                0) for e in prof.events()]
    else:
        raw = []
        for e in results.events():
            dev = e.device_type() != DeviceType.CPU
            # a kernel carries the correlation id of the runtime call that
            # launched it; some versions give it as the linked id
            corr = _call(e, "correlation_id")
            if dev and not corr:
                corr = _call(e, "linked_correlation_id")
            raw.append((e.name(), dev, e.start_ns(),
                        e.start_ns() + e.duration_ns(), corr))
    host_names = {r[0] for r in raw if not r[1]}
    return [r for r in raw if not (r[1] and r[0] in host_names)]


def collect(prof, unit_span: str, watch=()) -> DeviceTrace:
    """The DeviceTrace of the window that the span WINDOW_SPAN marks;
    watch: host span names whose launched device time `under` sums (a
    device operation counts under a span when the host call that launched
    it, matched by correlation id, began inside that span)."""
    raw = _raw_events(prof)
    win = [e for e in raw if not e[1] and e[0] == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = win[0][2], win[0][3]
    dev = sorted((s, e, n) for n, is_dev, s, e, _ in raw
                 if is_dev and e > w0 and s < w1 and e > s)
    host = sorted(((s, -e, n) for n, is_dev, s, e, _ in raw
                   if not is_dev and n != WINDOW_SPAN and e > w0 and s < w1),
                  key=lambda x: (x[0], x[1]))
    under = _under(raw, watch, w0, w1)
    ops = collections.Counter()
    busy, cur_s, cur_e = 0, None, None
    intervals = []
    for s, e, n in dev:
        s, e = max(s, w0), min(e, w1)
        ops[n] += (e - s) * 1e-9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                intervals.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        intervals.append((cur_s, cur_e))
    busy = sum(e - s for s, e in intervals)
    # idle gaps: before the first operation, between, after the last
    edges = [w0] + [x for iv in intervals for x in iv] + [w1]
    gap_list = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    gaps = collections.Counter()
    units = [(h[0], -h[1]) for h in host if h[2] == unit_span]
    unit_starts = [u[0] for u in units]
    inner = [h for h in host if h[2] != unit_span]
    stack, j = [], 0
    # one sweep over the gaps in time order, each named at its midpoint:
    # the host events begun by then, in start order, on a stack; the top
    # that is still open is the innermost host operation
    for g0, g1 in gap_list:
        tm = (g0 + g1) // 2
        while j < len(inner) and inner[j][0] <= tm:
            stack.append(inner[j])
            j += 1
        while stack and -stack[-1][1] < tm:
            stack.pop()
        k = bisect.bisect_right(unit_starts, tm) - 1
        outer = unit_span if k >= 0 and units[k][1] >= tm else "-"
        name = stack[-1][2] if stack else "-"
        gaps[f"{outer}/{name}"] += (g1 - g0) * 1e-9
    return DeviceTrace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                       ops=dict(ops), gaps=dict(gaps), under=under)


def _under(raw, watch, w0: int, w1: int) -> dict:
    """{span: device seconds of the operations launched inside it}."""
    out = {}
    if not watch:
        return out
    # the runtime's launch calls (cudaLaunchKernel, cuLaunchKernelEx, …)
    launch = {c: s for n, is_dev, s, e, c in raw
              if not is_dev and c and n.startswith("cu")}
    for span in watch:
        ranges = sorted((s, e) for n, is_dev, s, e, _ in raw
                        if not is_dev and n == span)
        starts = [r[0] for r in ranges]
        total = 0.0
        for n, is_dev, s, e, c in raw:
            if not is_dev or e <= w0 or s >= w1 or c not in launch:
                continue
            t = launch[c]
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and ranges[k][1] >= t:
                total += (min(e, w1) - max(s, w0)) * 1e-9
        out[span] = total
    return out


def _under(raw, watch, w0: int, w1: int) -> dict:
    """{span: device seconds of the operations launched inside it}."""
    out = {}
    if not watch:
        return out
    # the runtime's launch calls (cudaLaunchKernel, cuLaunchKernelEx, …)
    launch = {c: s for n, is_dev, s, e, c in raw
              if not is_dev and c and n.startswith("cu")}
    for span in watch:
        ranges = sorted((s, e) for n, is_dev, s, e, _ in raw
                        if not is_dev and n == span)
        starts = [r[0] for r in ranges]
        total = 0.0
        for n, is_dev, s, e, c in raw:
            if not is_dev or e <= w0 or s >= w1 or c not in launch:
                continue
            t = launch[c]
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and ranges[k][1] >= t:
                total += (min(e, w1) - max(s, w0)) * 1e-9
        out[span] = total
    return out


def _host_at(host, starts, units, unit_starts, t, unit_span: str) -> str:
    """"<unit span or ->/<innermost host op open at t or ->"."""
    k = bisect.bisect_right(unit_starts, t) - 1
    outer = unit_span if k >= 0 and units[k][1] >= t else "-"
    inner = "-"
    # the latest-begun host event still open at t is the innermost; look
    # back a bounded number of events
    for j in range(bisect.bisect_right(starts, t) - 1,
                   max(-1, bisect.bisect_right(starts, t) - 256), -1):
        s, neg_e, n = host[j]
        if -neg_e >= t and n != unit_span:
            inner = n
            break
    return f"{outer}/{inner}"
