"""Spans and counters recorded where the port's work happens.

Counters (:func:`count`) are integer adds under a name, always on:

- ``nms.copies``, ``nms.pair_overflows``: the NMS's device-to-host copies
  and the calls whose pair list outgrew its capacity (ops/nms.py);
- ``nms.rows``, ``nms.live``, ``nms.kept``: the candidate rows a call
  tests (slots x K), the live candidates among them, the boxes kept;
- ``span_conv.launches``, ``span_conv.slot_launches``: span-conv kernel
  launches, and those that also ran coverage slots (sparse/span_conv.py);
- ``plan.builds``, ``plan.replays``, ``plan.captures``: calls of the span
  plan builders on any path, those that replayed a CUDA graph, and the
  graphs captured (sparse/span_conv.py, ``PlanGraphs``);
- ``pipeline.steps``, ``pipeline.scans``: pipeline steps and the scans
  they took (pipeline.py);
- ``cp.points``, ``cp.voxels``, ``cp.voxels_dropped``, ``cp.candidates``:
  CenterPoint's merged points in range, voxels kept, voxels its capacity
  dropped and boxes over the score gate before NMS, counted where
  ``SweepPipeline.fetch`` brings a step's counts to the host;
- ``host_syncs``: operations that blocked the host until the card's stream
  drained, counted only while tracing is on, inside a span, on the card
  (``torch.cuda.set_sync_debug_mode("warn")``; each warning is counted and
  not shown, and the mode and the warning filters are put back when the
  outermost span closes).

Spans (``with obs.span(name):``) record only while tracing is on: while a
``torch.profiler`` session runs, or inside ``with obs.tracing():``. With
tracing off a span is one flag check that returns a shared no-op context.
A span records its host time on ``time.perf_counter_ns`` and its self time
(its duration less the part its child spans cover); under the profiler it
also opens ``record_function("insmos.<name>")``, so the trace holds the
program's spans on the clock of the device activities.

Spans are kept as step records, in a ring of the last :data:`RING` steps.
A record runs from one :func:`step` (the entry of ``push_scan`` or
``push_scans``) to the next, so a step's fetches count in it; it holds the
step's slots, per span name the count, inclusive and self ns, the host
syncs and the enclosing spans' names, and the deltas of every counter over
the step. :func:`records` returns them, :func:`summary` the totals by name
since :func:`reset`.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings

import torch
from torch.autograd import profiler as _prof

RING = 256
SYNC_MESSAGE = "synchronizing CUDA operation"

_counts: collections.Counter = collections.Counter()
_base: dict = {}  # counter values at the last reset()
_forced = 0  # depth of tracing() contexts
_stack: list = []  # the open spans, innermost last
_ring: collections.deque = collections.deque(maxlen=RING - 1)  # closed
_open = None  # the current step record
_totals: dict = {}  # name -> [count, incl_ns, self_ns, syncs] since reset()
_watch = None  # (previous sync debug mode, warnings context, showwarning)
_NULL = contextlib.nullcontext()


# ------------------------------------------------------------- counters
def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> dict:
    """Every counter's value now."""
    return dict(_counts)


def since(before: dict) -> collections.Counter:
    """What each counter gained since the snapshot ``before``
    (:func:`counters`); a counter that never moved reads 0."""
    return collections.Counter({k: v - before.get(k, 0)
                                for k, v in _counts.items()})


# ---------------------------------------------------------------- spans
def on() -> bool:
    """Whether spans record now."""
    return bool(_forced) or _prof._is_profiler_enabled


@contextlib.contextmanager
def tracing():
    """Spans record inside, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def span(name: str):
    """The context of a span named ``name`` (a no-op with tracing off)."""
    if not (_forced or _prof._is_profiler_enabled):
        return _NULL
    return _Span(name)


def step(slots: int):
    """The ``step`` span of a pipeline step over ``slots`` slots: it closes
    the current step record and opens the next. With tracing off it only
    closes the current record."""
    global _open
    if not (_forced or _prof._is_profiler_enabled):
        if _open is not None:
            _close()
        return _NULL
    _close()
    _open = _Record(slots)
    return _Span("step")


class _Record:
    __slots__ = ("slots", "start_ns", "end_ns", "spans", "base", "counts")

    def __init__(self, slots: int):
        self.slots = slots
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None
        self.spans = {}  # name -> [count, incl_ns, self_ns, syncs, parents]
        self.base = dict(_counts)
        self.counts = None  # the counter deltas, once closed

    def add(self, name, dur, self_ns, syncs, parent):
        s = self.spans.get(name)
        if s is None:
            s = self.spans[name] = [0, 0, 0, 0, collections.Counter()]
        s[0] += 1
        s[1] += dur
        s[2] += self_ns
        s[3] += syncs
        s[4][parent] += 1

    def deltas(self) -> dict:
        if self.counts is not None:
            return self.counts
        return {k: v - self.base.get(k, 0) for k, v in _counts.items()
                if v != self.base.get(k, 0)}

    def as_dict(self) -> dict:
        return {"slots": self.slots, "start_ns": self.start_ns,
                "end_ns": self.end_ns,
                "spans": {n: {"count": s[0], "incl_ns": s[1],
                              "self_ns": s[2], "syncs": s[3],
                              "parents": dict(s[4])}
                          for n, s in self.spans.items()},
                "counters": dict(self.deltas())}


def _close():
    global _open
    if _open is None:
        return
    _open.end_ns = time.perf_counter_ns()
    _open.counts = _open.deltas()
    _ring.append(_open)
    _open = None


class _Span:
    __slots__ = ("name", "t0", "child_ns", "syncs", "rf")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0
        self.syncs = 0
        self.rf = None

    def __enter__(self):
        if not _stack:
            _watch_syncs()
        if _prof._is_profiler_enabled:
            self.rf = _prof.record_function("insmos." + self.name)
            self.rf.__enter__()
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _open
        dur = time.perf_counter_ns() - self.t0
        _stack.pop()
        parent = _stack[-1].name if _stack else None
        if _stack:
            _stack[-1].child_ns += dur
        if _open is None:  # a span outside any step: a record of 0 slots
            _open = _Record(0)
        own = dur - self.child_ns
        _open.add(self.name, dur, own, self.syncs, parent)
        t = _totals.get(self.name)
        if t is None:
            t = _totals[self.name] = [0, 0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += own
        t[3] += self.syncs
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if not _stack:
            _unwatch_syncs()
        return False


# ------------------------------------------------------------ host syncs
def _watch_syncs():
    """Counts the card's synchronising operations into ``host_syncs`` and
    the innermost span until :func:`_unwatch_syncs`."""
    global _watch
    if not torch.cuda.is_initialized():
        return
    prev = torch.cuda.get_sync_debug_mode()
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
    # torch says so once a process, as the mode is first set
    warnings.filterwarnings("ignore", message="Synchronization debug mode")
    _watch = (prev, ctx, warnings.showwarning)
    warnings.showwarning = _on_warning
    torch.cuda.set_sync_debug_mode("warn")


def _unwatch_syncs():
    global _watch
    if _watch is None:
        return
    prev, ctx, _ = _watch
    torch.cuda.set_sync_debug_mode(prev)
    ctx.__exit__(None, None, None)
    _watch = None


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if SYNC_MESSAGE in str(message):
        _counts["host_syncs"] += 1
        if _stack:
            _stack[-1].syncs += 1
        return
    _watch[2](message, category, filename, lineno, file, line)


# --------------------------------------------------------------- reading
def records() -> list[dict]:
    """The step records, oldest first, the current (open) one last."""
    out = [r.as_dict() for r in _ring]
    if _open is not None:
        out.append(_open.as_dict())
    return out


def summary() -> dict:
    """Span totals by name since :func:`reset` (count, inclusive and self
    ms, host syncs inside the span itself) and what each counter gained."""
    return {
        "spans": {n: {"count": t[0], "incl_ms": t[1] * 1e-6,
                      "self_ms": t[2] * 1e-6, "syncs": t[3]}
                  for n, t in sorted(_totals.items())},
        "counters": {k: v - _base.get(k, 0) for k, v in sorted(_counts.items())
                     if v != _base.get(k, 0)},
        "records": len(_ring) + (_open is not None),
    }


def reset() -> None:
    """Forgets the step records and the span totals; :func:`summary`'s
    counters count from here."""
    global _open, _base
    _ring.clear()
    _open = None
    _totals.clear()
    _base = dict(_counts)
