"""The traced run's record: a bounded number of steps under
``torch.profiler``, read back from its Chrome trace.

The benchmark marks its own host ranges with ``record_function``:
``pb.step`` around a step, the model family's ranges around methods of
the model instance (``RANGES`` in ``families/<family>.py``, wrappers set
on the instance; InsMOS's ``pb.motion`` and ``pb.tail`` around
``forward_motion`` and ``forward_tail``), ``pb.fetch`` around the outputs'
copy to the host. A device
activity (kernel, copy or memset) is charged to the range, or the
program's custom op (``insmos::span_conv``, ``insmos::greedy_nms``), whose
host interval holds the runtime call that launched it (matched by the
trace's correlation id).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

from .stats import gaps, union_length

OPS = ("insmos::span_conv", "insmos::greedy_nms")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(step_fn, n_steps: int, model_ranges) -> dict:
    """Runs ``step_fn`` (one step, ending with its outputs on the host)
    ``n_steps`` times under the profiler and returns :func:`read` of the
    trace. The trace goes to a temporary file, deleted once read."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            with record_function("pb.step"):
                step_fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return read(events, model_ranges)


class _Intervals:
    """Disjoint host intervals of one name, for point lookups."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.spans = spans

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]


def read(events, model_ranges) -> dict:
    """The record a per-layer metric reads, from Chrome-trace events (times
    in microseconds): the traced window, device busy time (a union), the
    device activities charged to each range and op, the top device
    operations and the longest idle gaps with what the host was doing.
    ``model_ranges``: the family's (range name, gap label) pairs, inside
    ``pb.step`` and apart from ``pb.fetch``."""
    model_ranges = [tuple(r) for r in model_ranges]
    names = ("pb.step",) + tuple(n for n, _ in model_ranges) + ("pb.fetch",)
    # what the host was doing during an idle gap, innermost first
    gap_labels = model_ranges + [("pb.fetch", "fetch"), ("pb.step", "push")]
    ranges = defaultdict(list)
    launch = {}
    dev = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((s, e, name, ev.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            c = ev.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = s
        elif (name in names and cat == "user_annotation") or (
                name in OPS and cat in ("cpu_op", "user_annotation")):
            ranges[name].append((s, e))
    steps = sorted(ranges["pb.step"])
    if not steps:
        raise RuntimeError("the trace holds no pb.step range")
    w0, w1 = steps[0][0], steps[-1][1]
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    look = {n: _Intervals(ranges[n]) for n in names + OPS}
    charged = defaultdict(float)
    by_name = defaultdict(float)
    for s, e, name, corr in dev:
        by_name[name] += e - s
        t = launch.get(corr)
        if t is None:
            continue
        for n in names + OPS:
            if look[n].holds(t):
                charged[n] += e - s
    busy = [(max(s, w0), min(e, w1)) for s, e, _, _ in dev]
    idle = []
    for a, b in gaps(busy, w0, w1):
        mid = 0.5 * (a + b)
        label = "between steps"
        for n, lab in gap_labels:
            if look[n].holds(mid):
                label = lab
                break
        idle.append((label, (b - a) * 1e-6))
    idle.sort(key=lambda x: -x[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        steps=len(steps),
        window_s=(w1 - w0) * 1e-6,
        busy_s=union_length(busy) * 1e-6,
        activities=len(dev),
        charged_s={n: v * 1e-6 for n, v in charged.items()},
        device_ops=[[n[:120], v * 1e-6] for n, v in top],
        idle_gaps=[[lab, v] for lab, v in idle[:10]],
    )
