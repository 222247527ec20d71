"""The single-stream pipeline's span plans from CUDA graphs
(``sparse.span_conv.PlanGraphs``).

On the CPU: the group offsets uploaded once equal the per-call tensors for
every kernel the model uses; with graphs current, CPU inputs build the
eager plans and count builds without replays; the key tells two equal
calls of one step apart and a step restarts the occurrence count (a stand-in
for the capture, which needs the card); a vmapped input under current
graphs raises; the overflow tool copies the plans it keeps;
``plan_replay_pct`` reads the counters. On the card
(``gpu``): over 20 steps of each mode every graphed plan equals the eager
plan field for field, and a graphed pipeline's outputs, window and caches
equal those of a pipeline with eager plans, the fixed-frame recovery step
and the steps after it included; a step's outputs hold after two more
steps; the graphs captured are the distinct keys, each replayed at every
step.

No jax: the card runs it with
    python -m pytest --noconftest -m gpu tests/test_torch_plan_graphs.py
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from insmos_tpu_torch import obs
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.nn import minkunet4d as M4
from insmos_tpu_torch.nn import unet3d as U3
from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.sparse import span_conv as SC
from torch.utils import _pytree
from insmos_tpu_torch.utils.params import init_params, make_model

# cores shared among the pytest-xdist workers (tests/torch_port_common.py)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

KERNELS = {"stem": M4._K3_STEM, "down": M4._K3_DOWN, "block": M4._K3_BLOCK,
           "unet": U3._K3, "conv_out": U3._KZ}
STEPS = 20
BUILDS = ("plan.builds", "plan.replays", "plan.captures")


def _config(incremental=False):
    cfg = Config().tiny()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, n_past_steps=3),
        data=dataclasses.replace(
            cfg.data, point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)),
        runtime=dataclasses.replace(cfg.runtime, compute_dtype="float32",
                                    incremental_stem=incremental))


def _pipe(device, incremental=False):
    cfg = _config(incremental)
    params, state = init_params(cfg, np.random.default_rng(0))
    return InferencePipeline(cfg, make_model(cfg, params, state, device),
                             device)


def _scan(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform((-6.0, -6.0, -2.0), (6.0, 6.0, 0.5), (1500, 3))
    return np.concatenate([xyz, rng.random((1500, 1))], 1).astype(np.float32)


def _tf(step):
    """A step transform: an integer-voxel translation, and on step 7 a
    small turn (the fixed-frame mode's recovery step)."""
    tf = np.eye(4, dtype=np.float32)
    tf[0, 3] = 0.1 * (step % 3)
    if step == 7:
        c, s = np.cos(0.02), np.sin(0.02)
        tf[:2, :2] = [[c, -s], [s, c]]
    return tf


def _request(seed, V=300, dims=(24, 20, 10)):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(np.unique(rng.integers(
        0, dims[0] * dims[1] * dims[2], 800)).astype(np.int32))
    coords = torch.from_numpy(np.stack(
        [rng.integers(0, d, V) for d in dims], -1).astype(np.int32))
    valid = torch.from_numpy(rng.random(V) > 0.1)
    return keys, dict(out_coords=coords, out_valid=valid,
                      kernel3=(3, 3, 3), in_dims=dims, span=64, bs=32,
                      slots=16, gwin=6, pairs=16)


def _fields_equal(a, b):
    for f in dataclasses.fields(SC.SpanPlan):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_group_offsets_equal_per_call_tensors(name):
    k3 = KERNELS[name]
    groups = SC._groups_yz(k3)
    ky, kz = SC._group_offsets(k3, "cpu")
    for got, i in ((ky, 0), (kz, 1)):
        want = torch.tensor([g[i] for g in groups], dtype=torch.int64)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert not got.is_inference()
    with torch.inference_mode():
        assert SC._group_offsets(k3, torch.device("cpu"))[0] is ky


def test_cpu_step_builds_eager_plans():
    """Graphs current, CPU inputs: the eager plans, builds without
    replays, no graph; the pipeline's CPU step counts every plan."""
    keys, req = _request(0)
    eager = SC.make_span_plans(keys, [req, dict(req, kernel3=(2, 2, 2),
                                                 stride3=(2, 2, 2),
                                                 pad3=(0, 0, 0))])
    one = SC.make_span_plan(keys, **req)
    graphs = SC.PlanGraphs()
    before = obs.counters()
    with graphs.step():
        got = SC.make_span_plans(keys, [req, dict(req, kernel3=(2, 2, 2),
                                                   stride3=(2, 2, 2),
                                                   pad3=(0, 0, 0))])
        got_one = SC.make_span_plan(keys, **req)
    for a, b in zip(got + [got_one], eager + [one]):
        _fields_equal(a, b)
    moved = obs.since(before)
    assert [moved[k] for k in BUILDS] == [2, 0, 0] and len(graphs) == 0

    pipe = _pipe("cpu")
    before = obs.counters()
    scan = _scan(1)
    pipe.fetch(pipe.push_scan(scan), len(scan))
    moved = obs.since(before)
    # 7 plans in MotionNet (decoder pruned), 4 in the UNet
    assert [moved[k] for k in BUILDS] == [11, 0, 0]
    assert len(pipe.plan_graphs) == 0


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def test_key_tells_equal_calls_apart(monkeypatch):
    """Two equal calls of one step get graphs of their own; the next step
    replays them; another static argument is another key."""
    captured = []
    _FakeGraph.replays = 0

    def capture(self, inputs, requests):
        captured.append(requests[0]["gwin"])
        return _FakeGraph(), [t.clone() for t in inputs], \
            SC._make_span_plans(inputs[0], requests)

    monkeypatch.setattr(SC.PlanGraphs, "_capture", capture)
    keys, req = _request(2)
    graphs = SC.PlanGraphs()
    seen = []
    for step in range(3):
        with graphs.step():
            for r in (req, req, dict(req, gwin=8)):
                seen.append(graphs.replay(keys, [r]))
            seen.append(graphs.replay(keys, [dict(req, stride3=(1, 1, 1),
                                                  pad3=None)]))
        assert len(graphs) == 4 and len(captured) == 4
    assert captured == [6, 6, 8, 6]
    assert _FakeGraph.replays == 12
    # the two equal calls hold separate outputs; steps hand back the same
    first, second = seen[0][0], seen[1][0]
    assert first.sb is not second.sb and torch.equal(first.sb, second.sb)
    assert seen[4][0].sb is first.sb and seen[5][0].sb is second.sb
    _fields_equal(seen[3][0], SC.make_span_plan(keys, **req))


def test_overflow_capture_copies_plans():
    """The overflow tool keeps a plan of its own, not the one a graph's
    next replay overwrites."""
    from insmos_tpu_torch.tools import overflow_plans as OP

    keys, req = _request(4)
    plan = SC.make_span_plan(keys, **req)
    got = OP._copy(plan)
    _fields_equal(got, plan)
    for f in dataclasses.fields(SC.SpanPlan):
        if isinstance(getattr(plan, f.name), torch.Tensor):
            assert getattr(got, f.name).data_ptr() != \
                getattr(plan, f.name).data_ptr(), f.name


def test_vmapped_input_under_current_graphs_raises():
    keys, req = _request(3)
    kb = torch.stack([keys, keys])

    def plans(k):
        return SC.make_span_plans(k, [req])[0].sb

    assert torch.equal(torch.func.vmap(plans)(kb)[1],
                       SC.make_span_plans(keys, [req])[0].sb)
    with SC.PlanGraphs().step():
        with pytest.raises(ValueError, match="vmapped"):
            torch.func.vmap(plans)(kb)


def test_plan_replay_pct_reads_the_counters(monkeypatch):
    from portbench.run import load_metric

    metric = load_metric("plan_replay_pct")
    rec = dict(scans=2, streams=1, on_card=False)

    def records(*counters):
        monkeypatch.setattr(obs, "records",
                            lambda: [{"counters": c} for c in counters])

    records({"plan.builds": 11, "plan.replays": 11},
            {"plan.builds": 11, "plan.replays": 11})
    assert metric.read(rec) == 100.0
    records({"plan.builds": 11}, {"plan.builds": 11})
    assert metric.read(rec) == 0.0
    records({"host_syncs": 3}, {})  # a program without the counters
    assert metric.read(rec) is None
    records({"plan.builds": 11})  # fewer records than profiled steps
    assert metric.read(rec) is None


# ----------------------------------------------------------------- card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the plans replay CUDA graphs)")


@pytest.mark.gpu
@pytest.mark.parametrize("incremental", [False, True],
                         ids=["ref-exact", "fixed-frame"])
def test_graphed_plans_equal_eager(incremental):
    _card()
    import chip_smoke

    pipe = _pipe("cuda", incremental)
    before = obs.counters()
    with chip_smoke.PlanCheck() as check:
        for t in range(STEPS):
            scan = _scan(t)
            pipe.fetch(pipe.push_scan(scan, _tf(t)), len(scan))
    assert check.calls == obs.since(before)["plan.builds"] >= 11 * STEPS
    assert check.checked >= check.calls
    assert pipe.n_full_steps == (1 if incremental else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("incremental", [False, True],
                         ids=["ref-exact", "fixed-frame"])
def test_graphed_steps_equal_eager_steps(incremental):
    """A pipeline whose plans replay graphs returns the outputs, and
    carries the window and caches, of one whose plans are built eagerly,
    step for step over 20 steps: in the fixed-frame mode the recovery step
    (step 7) replays graphs captured only then, out of the other graphs'
    capture order, and the steps after it carry its stem cache on."""
    _card()
    graphed, eager = _pipe("cuda", incremental), _pipe("cuda", incremental)
    eager.plan_graphs.step = contextlib.nullcontext
    captures, replays = [], []
    for t in range(STEPS):
        scan = _scan(t)
        before = obs.counters()
        outs = [p.push_scan(scan, _tf(t)) for p in (graphed, eager)]
        moved = obs.since(before)
        captures.append(moved["plan.captures"])
        replays.append(moved["plan.replays"])
        got, want = (_pytree.tree_leaves((out, p._buf))
                     for p, out in zip((graphed, eager), outs))
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (t, i)
    assert graphed.n_full_steps == eager.n_full_steps == int(incremental)
    assert len(eager.plan_graphs) == 0
    # the fixed-frame mode's recovery step captures graphs of its own and
    # replays graphs captured before them too
    assert sum(captures) == len(graphed.plan_graphs) > 0
    assert (captures[7] > 0) == incremental and replays[7] > captures[7]


@pytest.mark.gpu
@pytest.mark.parametrize("incremental", [False, True],
                         ids=["ref-exact", "fixed-frame"])
def test_step_outputs_survive_later_steps(incremental):
    """Nothing a step returns lives in a graph's memory: two more steps
    leave it as it was."""
    _card()
    pipe = _pipe("cuda", incremental)
    for t in range(3):
        pipe.push_scan(_scan(t), _tf(t))
    out = pipe.push_scan(_scan(3), _tf(3))
    kept = {k: v.clone() for k, v in out.items() if k != "overflow"}
    kept.update({"overflow." + k: v.clone()
                 for k, v in out["overflow"].items()})
    for t in (4, 5):
        pipe.push_scan(_scan(100 + t), _tf(t))
    torch.cuda.synchronize()
    now = dict(out, **{"overflow." + k: v
                       for k, v in out["overflow"].items()})
    for k, v in kept.items():
        assert torch.equal(now[k], v), k


@pytest.mark.gpu
def test_captures_are_the_distinct_keys():
    _card()
    pipe = _pipe("cuda")
    before = obs.counters()
    scan = _scan(0)
    pipe.fetch(pipe.push_scan(scan), len(scan))
    first = obs.since(before)
    assert first["plan.captures"] == first["plan.builds"] == 11
    assert first["plan.replays"] == 11 and len(pipe.plan_graphs) == 11
    for t in range(1, 4):
        scan = _scan(t)
        pipe.fetch(pipe.push_scan(scan), len(scan))
    moved = obs.since(before)
    assert moved["plan.captures"] == 11 and len(pipe.plan_graphs) == 11
    assert moved["plan.replays"] == moved["plan.builds"] == 44
