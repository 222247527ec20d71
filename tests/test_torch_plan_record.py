"""The JAX package's span-plan record (tests/torch_plan_record.py), which
``chip_smoke.py``'s ``phase_pod`` holds the port's span overflow against
on the card.

The record's own function, at a tiny config on the CPU, against the port's
single-stream pipeline on the same stream, in both modes: every step's
span_overflow per plan equal (the same plans, in the same order, with the
same counts). Then the committed record: every stream and step that
``phase_pod`` runs is in it, one count a plan."""

import numpy as np
import pytest

from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.utils.params import init_params, make_model

from test_torch_model import port_config
from test_torch_pod import MODES, _config, _streams
from torch_plan_record import STREAMS, jax_counters, load_record

N_STEPS = 3


@pytest.mark.parametrize("mode", MODES)
def test_jax_plan_counters_match_the_port(mode):
    pcfg = port_config(_config(mode))
    params, state = init_params(pcfg, np.random.default_rng(0))
    scans, tfs = zip(*_streams(mode)[0][:N_STEPS])
    ref = jax_counters(pcfg, "fixed-frame" if mode == "incremental"
                       else "ref-exact", scans, tfs)
    pipe = InferencePipeline(pcfg, make_model(pcfg, params, state, "cpu"),
                             "cpu")
    got = [pipe.push_scan(s, tf)["overflow"]["span_overflow"].tolist()
           for s, tf in zip(scans, tfs)]
    assert got == [r["span_overflow"] for r in ref]
    assert len(got[0]) == 18 and all(r["dropped"] == 0 for r in ref)


def test_record_covers_the_pod_streams():
    rec = load_record()["streams"]
    assert sorted(rec) == sorted(f"{m}/{s}" for m, seeds, _ in STREAMS
                                 for s in seeds)
    for mode, seeds, n in STREAMS:
        for s in seeds:
            rows = rec[f"{mode}/{s}"]
            assert len(rows) == n
            for r in rows:
                assert len(r["span_overflow"]) == 18
                assert min(r["span_overflow"]) >= 0 and r["dropped"] == 0
    # the main path's stream (seed 0) is covered at every full-window step
    # of its first 12; the S = 1, 2, 4 readings run steps 10-19
    assert not any(any(r["span_overflow"]) for r in rec["ref-exact/0"][9:12])
