"""The per-layer metrics that read the program's own spans and counters
(``insmos_tpu_torch.obs``): on step records made on the CPU under the
profiler, as a traced run makes them, each reads a finite value but
``host_syncs_per_step``, which counts only on the card; with fewer step
records than profiled steps each reads nothing."""

import dataclasses
import math

import numpy as np
import pytest

from portbench.run import load_metric

SPANS = ("push_host_ms", "motion_host_ms", "tail_host_ms", "plan_host_ms",
         "nms_host_ms")
METRICS = SPANS + ("host_syncs_per_step", "nms_live_pct")
STEPS = 2


def _scan(rng):
    xyz = rng.uniform((-6.0, -6.0, -2.0), (6.0, 6.0, 0.5), (1500, 3))
    return np.concatenate([xyz, rng.random((1500, 1))], 1).astype(np.float32)


@pytest.fixture(scope="module")
def traced():
    """A tiny pipeline's first scan untraced, then STEPS steps under a CPU
    profiler; the run's record as a traced run hands it to the readers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from insmos_tpu_torch import obs
    from insmos_tpu_torch.config import Config
    from insmos_tpu_torch.pipeline import InferencePipeline
    from insmos_tpu_torch.utils.params import init_params, make_model

    torch.set_num_threads(2)
    cfg = Config().tiny()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, n_past_steps=3),
        data=dataclasses.replace(
            cfg.data, point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)),
        runtime=dataclasses.replace(cfg.runtime, compute_dtype="float32"))
    pipe = InferencePipeline(cfg, make_model(
        cfg, *init_params(cfg, np.random.default_rng(0)), "cpu"), "cpu")
    rng = np.random.default_rng(1)

    def step():
        scan = _scan(rng)
        pipe.fetch(pipe.push_scan(scan), len(scan))

    step()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(STEPS):
            step()
    return dict(scans=STEPS, streams=1, on_card=False)


@pytest.mark.parametrize("name", METRICS)
def test_reads_the_step_records(traced, name):
    v = load_metric(name).read(traced)
    if name == "host_syncs_per_step":
        assert v is None
    else:
        assert v is not None and math.isfinite(v) and v >= 0
    if name == "nms_live_pct":
        assert v <= 100.0


def test_span_metrics_are_per_scan(traced):
    from insmos_tpu_torch import obs

    recs = obs.records()[-STEPS:]
    ns = sum(r["spans"]["motion"]["incl_ns"] for r in recs)
    assert load_metric("motion_host_ms").read(traced) == pytest.approx(
        ns * 1e-6 / STEPS)
    assert load_metric("motion_host_ms").read(dict(traced, scans=2 * STEPS,
                                                   streams=2)) \
        == pytest.approx(ns * 1e-6 / (2 * STEPS))


@pytest.mark.parametrize("name", METRICS)
def test_too_few_records_read_nothing(traced, name):
    assert load_metric(name).read(dict(traced, scans=STEPS + 1)) is None
