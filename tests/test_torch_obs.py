"""The port's spans and counters (insmos_tpu_torch/obs.py).

Spans nest and keep their self time; with tracing off a pipeline step
records nothing, opens no ``record_function`` and leaves the sync debug
mode alone, while the counters still move. Under a CPU ``torch.profiler``
one step of a tiny ``InferencePipeline`` and one of a tiny 2-slot
``PodInferencePipeline`` (vmapped, fallback off) each give one step record
whose spans nest as the model does and match the trace's ``insmos.*``
events. On the card (``gpu``), a traced step counts at least the host
syncs its explicit copies make and puts the sync debug mode back.

No jax: the card runs it with
    python -m pytest --noconftest -m gpu tests/test_torch_obs.py
"""

import dataclasses
import os
import time
import warnings

import numpy as np
import pytest
import torch

from insmos_tpu_torch import obs
from insmos_tpu_torch.config import Config, DataConfig, MotionNetConfig
from insmos_tpu_torch.pipeline import InferencePipeline, PodInferencePipeline
from insmos_tpu_torch.utils.params import init_params, make_model

# cores shared among the pytest-xdist workers (tests/torch_port_common.py)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

POINTS = 2048
# span -> the span that encloses it in a step
NESTING = {"step": None, "push": "step", "motion": "step",
           "voxelize": "motion", "tail": "step", "detect": "tail",
           "nms": "detect", "sync.nms": "nms", "fetch": None,
           "sync.fetch": "fetch"}


def _config():
    base = Config()
    return dataclasses.replace(
        base,
        data=DataConfig(point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)),
        model=dataclasses.replace(
            base.model, n_past_steps=3, max_voxels=4096,
            unet_capacities=(4096, 2048, 1024, 512, 512),
            motionnet=MotionNetConfig(
                crop_range=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.8),
                site_capacities=(8192, 4096, 2048, 1024))),
        runtime=dataclasses.replace(
            base.runtime, max_points_per_scan=POINTS,
            compute_dtype="float32"))


def _scan(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform((-6.0, -6.0, -2.0), (6.0, 6.0, 0.5), (1500, 3))
    return np.concatenate([xyz, rng.random((1500, 1))], 1).astype(np.float32)


def _pipe(kind, device):
    cfg = _config()
    params, state = init_params(cfg, np.random.default_rng(0))
    model = make_model(cfg, params, state, device)
    if kind == "single":
        return InferencePipeline(cfg, model, device)
    return PodInferencePipeline(cfg, model, [device], slots_per_device=2)


def _step(pipe, seed=0):
    """One step and every stream's outputs on the host."""
    if isinstance(pipe, InferencePipeline):
        scan = _scan(seed)
        return [pipe.fetch(pipe.push_scan(scan), len(scan))]
    scans = [_scan(seed), _scan(seed + 1)]
    out = pipe.push_scans(scans)
    return [pipe.fetch(out, i, len(s)) for i, s in enumerate(scans)]


@pytest.fixture(scope="module", params=["single", "pod"])
def cpu_pipe(request):
    pipe = _pipe(request.param, "cpu")
    _step(pipe)  # the window's first scan, untraced
    return request.param, pipe


def test_spans_nest_and_keep_self_time():
    obs.reset()
    with obs.tracing():
        with obs.step(3):
            with obs.span("a"):
                time.sleep(0.002)
                with obs.span("b"):
                    time.sleep(0.003)
                with obs.span("b"):
                    pass
    (rec,) = obs.records()
    sp = rec["spans"]
    assert rec["slots"] == 3
    assert sp["b"]["count"] == 2 and sp["b"]["parents"] == {"a": 2}
    assert sp["a"]["parents"] == {"step": 1}
    assert sp["step"]["parents"] == {None: 1}
    for name, child in (("a", "b"), ("step", "a")):
        assert sp[name]["self_ns"] == sp[name]["incl_ns"] - sp[child]["incl_ns"]
    assert sp["b"]["incl_ns"] >= 3_000_000
    assert sp["b"]["self_ns"] == sp["b"]["incl_ns"]
    assert sp["a"]["self_ns"] >= 2_000_000
    s = obs.summary()
    assert s["spans"]["b"]["count"] == 2
    assert s["spans"]["a"]["self_ms"] == pytest.approx(
        sp["a"]["self_ns"] * 1e-6)
    obs.reset()
    assert obs.records() == [] and obs.summary()["spans"] == {}


def test_counters_always_count():
    before = obs.counters()
    obs.count("test.a")
    obs.count("test.a", 4)
    moved = obs.since(before)
    assert moved["test.a"] == 5 and moved["test.never"] == 0


def test_record_closes_at_the_next_step():
    """A record runs to the next step's entry, traced or not, and the ring
    keeps the last RING steps."""
    obs.reset()
    with obs.tracing():
        with obs.step(1):
            obs.count("test.b")
    obs.count("test.b")  # after the step, before the next: in its record
    with obs.step(1):  # untraced: closes the record, opens none
        obs.count("test.b")
    (rec,) = obs.records()
    assert rec["end_ns"] is not None and rec["counters"]["test.b"] == 2
    with obs.tracing():
        for _ in range(obs.RING + 5):
            with obs.step(1):
                pass
    assert len(obs.records()) == obs.RING
    obs.reset()


def test_tracing_off_records_nothing(cpu_pipe, monkeypatch):
    kind, pipe = cpu_pipe
    opened = []
    monkeypatch.setattr(obs._prof, "record_function",
                        lambda *a: opened.append(a))
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *a: opened.append(a))
    obs.reset()
    before = obs.counters()
    _step(pipe, 10)
    assert not obs.on()
    assert obs.records() == [] and obs.summary()["spans"] == {}
    assert opened == []
    moved = obs.since(before)
    assert moved["nms.copies"] == 1 and moved["pipeline.steps"] == 1
    assert moved["pipeline.scans"] == (1 if kind == "single" else 2)
    assert moved["host_syncs"] == 0


def test_profiled_step_gives_one_record(cpu_pipe):
    kind, pipe = cpu_pipe
    from torch.profiler import ProfilerActivity, profile

    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(pipe, 20)
    assert not obs.on()
    (rec,) = obs.records()
    S = 1 if kind == "single" else 2
    assert rec["slots"] == S
    sp = rec["spans"]
    for name, parent in NESTING.items():
        assert parent in sp[name]["parents"], (name, sp[name]["parents"])
        assert sp[name]["self_ns"] <= sp[name]["incl_ns"]
    assert set(sp["plan"]["parents"]) <= {"motion", "tail"}
    assert sp["plan"]["parents"].get("motion", 0) > 0
    assert sp["fetch"]["count"] == S and sp["nms"]["count"] == 1
    # step ⊃ push, motion, tail: the children fit in the step
    assert sum(sp[n]["incl_ns"] for n in ("push", "motion", "tail")) \
        <= sp["step"]["incl_ns"]
    c = rec["counters"]
    assert c["nms.copies"] == 1 and c["pipeline.steps"] == 1
    assert c["pipeline.scans"] == S
    assert c["nms.rows"] > 0 and 0 <= c.get("nms.live", 0) <= c["nms.rows"]
    assert c.get("host_syncs", 0) == 0  # no card
    events = {}
    for ev in prof.events():
        if ev.name.startswith("insmos."):
            events[ev.name[7:]] = events.get(ev.name[7:], 0) + 1
    assert events == {n: s["count"] for n, s in sp.items()}
    obs.reset()


@pytest.mark.gpu
def test_card_step_counts_syncs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (host syncs are counted there)")
    pipe = _pipe("single", "cuda")
    _step(pipe)
    prev = torch.cuda.get_sync_debug_mode()
    filters = list(warnings.filters)
    obs.reset()
    before = obs.counters()
    with obs.tracing():
        _step(pipe, 30)
    moved = obs.since(before)
    assert torch.cuda.get_sync_debug_mode() == prev
    assert list(warnings.filters) == filters
    # the NMS's copies and the fetch's five copies block the host
    assert moved["host_syncs"] >= moved["nms.copies"] + 5
    (rec,) = obs.records()
    assert rec["counters"]["host_syncs"] == moved["host_syncs"]
    sp = rec["spans"]
    assert sp["sync.nms"]["syncs"] >= 1 and sp["sync.fetch"]["syncs"] >= 5
    assert sum(s["syncs"] for s in sp.values()) == moved["host_syncs"]
    obs.reset()
