"""The overflow record (tests/torch_overflow_record.py and
insmos_tpu_torch/tools/overflow_plans.py): its comparison of the port's
plain span conv with the JAX span kernel (interpret mode) on a plan whose
budgets leave rows uncovered, at a small size; the rows the port calls
uncovered are those that miss taps; the committed record."""

import json
import os

import numpy as np
import pytest
import torch

from insmos_tpu_torch.config import Config
from insmos_tpu_torch.sparse import span_conv as tsc
from insmos_tpu_torch.tools import overflow_plans as OP
from insmos_tpu_torch.tools import stream_record as SR

import torch_overflow_record
from test_torch_span_conv import _slabs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forced_overflow(seed, span=32, slots=8, T=2, cin=4, cout=5, parts=1):
    """A 3^4 conv (``parts`` input parts) whose plan's span, slots and
    pairs are cut so that it leaves rows uncovered, as captured
    (span_conv_parts' arguments)."""
    rng = np.random.default_rng(seed)
    dims = (24, 20, 10)
    _, tsl = _slabs(rng, 700, dims, T, cin * parts, 1024)
    plan = tsc.make_span_plan(tsl.keys, tsl.coords, tsl.valid, (3, 3, 3),
                              in_dims=dims, span=span, slots=slots, gwin=2,
                              bs=32)
    ws = [torch.from_numpy((0.2 * rng.normal(size=(81, cin, cout))).astype(
        np.float32)) for _ in range(parts)]
    cp = tuple(tsc.ConvPart(cin, cout, T, 3, i * T * cin, 0)
               for i in range(parts))
    return (tsl.keys, tsl.feats, ws, cp, tsl.coords, tsl.valid, plan, T)


@pytest.mark.parametrize("case", [dict(), dict(parts=2),
                                  dict(span=48, slots=4)],
                         ids=["one_part", "two_parts", "span48"])
def test_overflowing_plan_matches_jax(case):
    """Every row (the uncovered ones included) within the record's TOL of
    the JAX span kernel, exact uncovered counts equal and non-zero."""
    args = _forced_overflow(3, **case)
    assert int(args[6].n_overflow) > 0
    r = torch_overflow_record.compare_conv(args)
    assert r["exact_uncovered"] == r["exact_uncovered_port"] > 0
    assert 0 < r["uncovered_rows"] <= r["exact_uncovered"]
    assert r["max_rel"] <= torch_overflow_record.TOL
    assert r["max_rel_uncovered"] <= torch_overflow_record.TOL
    assert r["sum"] == pytest.approx(r["port_sum"], rel=1e-5, abs=1e-3)


def test_uncovered_rows_are_those_missing_taps():
    """The rows uncovered_rows names differ from the conv with every tap
    (the same conv on a plan whose budgets cover all rows); every other
    row equals it."""
    x_keys, feats, ws, cp, oc, ov, plan, T = _forced_overflow(4)
    rows = tsc.uncovered_rows(x_keys, oc, ov, plan)
    full = tsc.make_span_plan(x_keys, oc, ov, (3, 3, 3),
                              in_dims=plan.in_dims, span=1024, bs=32)
    assert int(full.n_overflow) == 0
    cut = tsc.span_conv_parts_plain(x_keys, feats, ws, cp, oc, ov, plan, T)
    ref = tsc.span_conv_parts_plain(x_keys, feats, ws, cp, oc, ov, full, T)
    diff = (cut - ref).abs().amax(dim=1) > 1e-5
    assert rows.any()
    assert not (diff & ~rows).any()
    assert diff[rows].float().mean() > 0.5


def test_committed_overflow_record():
    """The committed record holds, on calibrated_params' weights, each plan
    of seed 0's streams that overflows (the warm-up ones, and ref-exact
    steps 15-19's decoder L2): exact counts equal and non-zero,
    every row of the port within TOL of the JAX kernel's, and the output
    sums the chip run holds the card against."""
    with open(os.path.join(REPO, OP.RECORD)) as f:
        rec = json.load(f)
    cfg = Config()
    assert rec["fingerprint"] == SR.fingerprint(*SR.calibrated_params(cfg))
    assert rec["tol"] == torch_overflow_record.TOL
    plans = {n.rsplit("/", 1)[0] for n in rec["convs"]}
    assert plans == {"ref_exact/3/block L2", "ref_exact/5/dec L1",
                     "fixed_frame/5/dec L2", "fixed_frame/8/stem_scan",
                     "fixed_frame/8/dec L1"} | {
                         f"ref_exact/{t}/dec L2" for t in range(15, 20)}
    for name, r in rec["convs"].items():
        assert r["exact_uncovered"] == r["exact_uncovered_port"] > 0, name
        assert 0 < r["uncovered_rows"] <= r["exact_uncovered"], name
        assert r["max_rel"] <= rec["tol"], name
        assert np.isfinite([r["sum"], r["abs_sum"]]).all()
