"""The span convs whose plans leave rows uncovered on the fixture
streams, captured for comparison.

A span plan's budgets (its span, its slots and pairs) can leave some
(site, group) window rows uncovered: the conv then leaves those taps out,
as the JAX package's kernel does, and the step reports the rows in its
``span_overflow`` counter. On seed 0 this happens on warm-up steps and
on steps 15-19 of the ref-exact stream, which the stream records never
compare (the JAX record runs the windowed engine, which has no plans, and
streams 12 steps). :func:`capture` streams a fixture stream
through the port's pipeline and keeps the inputs of every span conv whose
plan reports an overflow; ``tests/torch_overflow_record.py`` holds the
port's plain version against the JAX kernel on them and writes
:data:`RECORD`, and ``chip_smoke.py`` holds the card's kernels against the
plain version and the record's sums.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..data.hdl64 import make_fixed_frame_stream, make_stream
from ..pipeline import InferencePipeline
from ..sparse import span_conv as SC
from ..utils.params import make_model
from .validate_plan_budgets import PLAN_NAMES

RECORD = os.path.join("tests", "torch_goldens", "overflow_record.json")
# (stream, steps): on seed 0 the plans overflow on warm-up steps up to
# ref-exact step 5 and fixed-frame step 8, and on ref-exact full-window
# steps 15-19 (the decoder L2 plan), which a 20-step run times
STREAMS = (("ref_exact", 20), ("fixed_frame", 9))


def request_of(plan: SC.SpanPlan) -> dict:
    """The make_span_plan keywords that rebuild ``plan``."""
    return dict(kernel3=plan.kernel3, stride3=plan.stride3, pad3=plan.pad3,
                in_dims=plan.in_dims, span=plan.span, bs=plan.bs,
                slots=plan.js, gwin=plan.gwin, pairs=plan.jp)


def _plan_name(stream: str, vector, n_overflow: int) -> str:
    """The name of the plan whose entry of the step's span_overflow vector
    is ``n_overflow``."""
    hits = [PLAN_NAMES[stream][i] for i, v in enumerate(vector)
            if int(v) == n_overflow]
    if len(hits) != 1:
        raise AssertionError(f"{stream}: span_overflow {vector} has "
                             f"{len(hits)} plans at {n_overflow}")
    return hits[0]


def _copy(v):
    """A captured argument that later steps leave as it is: tensors,
    lists of them and plans are cloned (on the card a plan lives in its
    CUDA graph's outputs, which the next step's replay overwrites)."""
    if isinstance(v, list):
        return [a.clone() for a in v]
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, SC.SpanPlan):
        return dataclasses.replace(v, **{
            f.name: getattr(v, f.name).clone()
            for f in dataclasses.fields(v)
            if isinstance(getattr(v, f.name), torch.Tensor)})
    return v


def capture(cfg, stream: str, n_steps: int, params, state, device):
    """Streams ``stream`` (seed 0) for ``n_steps`` through the port's
    pipeline on ``device`` at ``cfg`` with the given weight trees. Returns
    {"<stream>/<step>/<plan>/<k>": the k-th span conv on that plan, as the
    arguments of span_conv_parts (x_keys, feats_cat, weights, parts,
    out_coords, out_valid, plan, T_out)} over every plan that reported
    n_overflow > 0."""
    if stream == "fixed_frame":
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, incremental_stem=True))
        scans, tfs, _ = make_fixed_frame_stream(cfg, n_steps, seed=0)
    else:
        scans, tfs = make_stream(cfg, n_steps, seed=0)
    pipe = InferencePipeline(cfg, make_model(cfg, params, state, device),
                             device)
    orig = SC.span_conv_parts
    calls = []

    def keep(*args):
        out = orig(*args)
        if int(args[6].n_overflow):
            calls.append(tuple(_copy(v) for v in args))
        return out

    caps = {}
    SC.span_conv_parts = keep
    try:
        for t, (scan, tf) in enumerate(zip(scans, tfs)):
            calls.clear()
            vector = pipe.push_scan(scan, tf)["overflow"]["span_overflow"]
            seen = {}
            for args in calls:
                plan = _plan_name(stream, vector.tolist(),
                                  int(args[6].n_overflow))
                k = seen[plan] = seen.get(plan, -1) + 1
                caps[f"{stream}/{t}/{plan}/{k}"] = args
    finally:
        SC.span_conv_parts = orig
    return caps


def port_conv(args):
    """The port's exact plan and plain span conv on one captured conv.
    Returns (its output, its exact uncovered count, its rows with
    uncovered taps), as numpy."""
    x_keys, feats_cat, weights, parts, oc, ov, plan, T_out = args
    exact = SC.make_span_plan(x_keys, oc, ov, exact_stats=True,
                              **request_of(plan))
    out = SC.span_conv_parts_plain(x_keys, feats_cat, weights, parts, oc,
                                   ov, exact, T_out)
    rows = SC.uncovered_rows(x_keys, oc, ov, exact)
    return (out.cpu().numpy(), int(exact.n_overflow),
            rows.cpu().numpy())


def sums(out: torch.Tensor) -> dict:
    """Float64 sums of a conv's output, as the record keeps them."""
    o = out.detach().double()
    return dict(sum=float(o.sum()), abs_sum=float(o.abs().sum()))


def sum_error(got: dict, ref: dict) -> float:
    """|sum - record's sum| as a share of the record's sum of |out|."""
    return abs(got["sum"] - ref["sum"]) / max(ref["abs_sum"], 1e-30)
