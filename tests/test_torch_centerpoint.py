"""CenterPoint (voxel 0.075 m, nuScenes, 10 sweeps) on the port's path,
held to the benchmark's plain reference (portbench/reference/centerpoint.py)
on the CPU.

A small configuration: the published widths on a 19.2 m square, 10
sweeps of at most 2,048 points of the nus32 drive cut to the square. The
BN statistics are calibrated by the reference on the window the step
sees (every BN normalising by its input's own statistics), the heatmap
head made steep, as the benchmark's weights are made. Held:

- the sweep window (merged points, their order and lags) equals the
  reference's after every one of 12 pushes;
- the float32 step: every head map of the six groups within 2e-5 of the
  reference's largest magnitude, and the kept boxes, velocities included,
  the same set, each number within 1e-4 (absolute and relative);
- the bf16 step within the configuration's check limits;
- ``greedy_nms_slots`` over six groups equals six ``greedy_nms`` calls;
- a residual block with its conv biases folded into its BN equals the
  block with the biases explicit;
- a traced step records the new spans and the ``cp.*`` counters;
- the benchmark's configuration file is the published configuration.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from insmos_tpu_torch import obs
from insmos_tpu_torch.centerpoint_config import CenterPointConfig
from insmos_tpu_torch.nn.blocks_slab import BasicBlock, basic_block_slab
from insmos_tpu_torch.nn.centerpoint import CenterPointModel, merge_sweeps
from insmos_tpu_torch.nn.voxel_res_backbone import fold_block_bias
from insmos_tpu_torch.ops.nms import greedy_nms, greedy_nms_slots
from insmos_tpu_torch.pipeline import SweepPipeline
from insmos_tpu_torch.sparse.slab import Slab
from insmos_tpu_torch.sparse.span_conv import make_span_plans
from portbench import cp_weights, traffic
from portbench.reference import centerpoint as ref
from portbench.reference.model import T, Net, Sites
from portbench.run import load_family, load_mix

# cores shared among the pytest-xdist workers (tests/torch_port_common.py)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HALF = 9.6
POINTS = 2048
PUSHES = 12
SEED = 2**31 + 29
HM_SCALE, HM_BIAS = 3.0, -4.595


def small_config(dtype="float32") -> CenterPointConfig:
    base = CenterPointConfig()
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, point_cloud_range=(-HALF, -HALF, -5.0, HALF, HALF,
                                          3.0)),
        model=dataclasses.replace(base.model, backbone=dataclasses.replace(
            base.model.backbone, max_voxels=16384,
            site_capacities=(32768, 16384, 8192, 4096))),
        runtime=dataclasses.replace(base.runtime, max_points_per_scan=POINTS,
                                    compute_dtype=dtype))


def _cd(cfg) -> dict:
    return json.loads(json.dumps(cfg.to_dict()))


def _sweeps(seed, n):
    """The nus32 drive's first n sweeps, cut to the square."""
    st = traffic.Stream(seed, load_mix("nus32"), 34688, False, 0.075, n)
    out = []
    for _ in range(n):
        s, tf = st.next()
        keep = (np.abs(s[:, 0]) < HALF + 0.9) & (np.abs(s[:, 1]) < HALF + 0.9)
        out.append((s[keep][:POINTS], tf))
    return out


@pytest.fixture(scope="module")
def weights():
    """The recipe, BN statistics calibrated by the reference on the last
    window of the stream, a steep heatmap head (reference layout)."""
    cd = _cd(small_config())
    sd = cp_weights.state_dict(cd, "cpu", calibrated=False)
    scans, tfs = _window(_sweeps(SEED, PUSHES), PUSHES - 1)
    stats = {}
    ref.step(cd, sd, scans, tfs, calib=stats)
    for name, (mean, var) in stats.items():
        sd[f"{name}.mean"], sd[f"{name}.var"] = mean, var
    for q in cp_weights.hm_names(cd):
        sd[f"{q}.w"] = sd[f"{q}.w"] * HM_SCALE
        sd[f"{q}.b"] = torch.full_like(sd[f"{q}.b"], HM_BIAS)
    return sd


class _Recorder(torch.nn.Module):
    """A stand-in model: keeps the merged cloud of every step."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.clouds = []

    def forward_backbone3d(self, window):
        feats, valid = merge_sweeps(self.cfg, window)
        self.clouds.append(feats[valid].clone())
        return {}

    def forward_dense(self, inter):
        return inter

    def forward_post(self, inter):
        return inter


@pytest.fixture(scope="module")
def stream():
    """(sweeps, the pipeline's merged cloud after each push, its window
    after the last-but-one push)."""
    cfg = small_config()
    items = _sweeps(SEED, PUSHES)
    rec = _Recorder(cfg)
    pipe = SweepPipeline(cfg, rec, "cpu")
    bufs = []
    for s, tf in items:
        pipe.push_scan(s, tf)
        bufs.append(pipe._buf)
    return items, rec.clouds, bufs


def _window(items, end):
    lo = max(0, end - 9)
    pad = [None] * (10 - (end + 1 - lo))
    return (pad + [s for s, _ in items[lo:end + 1]],
            pad + [t for _, t in items[lo:end + 1]])


def test_window_matches_reference(stream):
    items, clouds, _ = stream
    cd = _cd(small_config())
    assert len(clouds) == PUSHES
    for end in range(PUSHES):
        scans, tfs = _window(items, end)
        pts, num, near = ref.sweep_window(cd, scans, tfs, "cpu")
        want = ref.merged_cloud(cd, pts, num, near)
        got = clouds[end]
        assert got.shape == want.shape, end
        assert torch.equal(got, want), end
    lags = torch.unique(clouds[-1][:, 4])
    assert torch.allclose(lags, torch.arange(10) * 0.05)


def _run(cfg, sd, buf, item, traced=False):
    """One pipeline step on the window ``buf`` (the state before the
    push) with ``item`` pushed; (outputs on the host, device outputs,
    dense maps of that window, the step records where ``traced``)."""
    model = CenterPointModel(cfg)
    model.load_state_dict(fold_block_bias(sd))
    pipe = SweepPipeline(cfg, model, "cpu")
    pipe._buf = buf
    obs.reset()
    records = None
    if traced:
        with obs.tracing():
            out = pipe.push_scan(*item)
            host = pipe.fetch(out)
        records = obs.records()
    else:
        out = pipe.push_scan(*item)
        host = pipe.fetch(out)
    with torch.inference_mode():
        maps = model.forward_dense(model.forward_backbone3d(pipe._buf))["maps"]
    return host, out, maps, records


@pytest.fixture(scope="module")
def f32_step(stream, weights):
    items, _, bufs = stream
    host, out, maps, records = _run(small_config(), weights, bufs[-2],
                                    items[-1], traced=True)
    scans, tfs = _window(items, PUSHES - 1)
    want = ref.step(_cd(small_config()), weights, scans, tfs,
                    with_maps=True)
    return host, out, maps, want, records


def test_gates_clear(f32_step):
    _, out, _, _, _ = f32_step
    for k, v in out["overflow"].items():
        assert int(v.sum()) == 0, (k, v)


def test_maps_match_reference(f32_step):
    _, _, maps, want, _ = f32_step
    assert len(maps) == len(want["maps"]) == 6
    n = 0
    for got, ref_maps in zip(maps, want["maps"]):
        assert list(got) == list(ref_maps)
        for k, w in ref_maps.items():
            g = got[k].numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), k
            n += 1
    assert n == 36


def test_boxes_match_reference(f32_step):
    host, out, _, want, _ = f32_step
    assert 20 <= len(want["scores"]) <= 400
    assert len(host["scores"]) == len(want["scores"])
    # the same set: each group's kept boxes in the same order
    np.testing.assert_array_equal(host["labels"], want["labels"])
    np.testing.assert_allclose(host["scores"], want["scores"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(host["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-4)
    counts = out["counts"].tolist()
    assert counts[0] == want["counts"]["points"]
    assert counts[1] == want["counts"]["voxels"]
    assert counts[2] == 0
    assert counts[3] == want["counts"]["candidates"]
    assert counts[3] > len(want["scores"])  # NMS suppressed some


def test_bf16_within_limits(stream, weights, f32_step):
    items, _, bufs = stream
    _, _, _, want, _ = f32_step
    host, _, _, _ = _run(small_config("bfloat16"), weights, bufs[-2],
                         items[-1])
    fam = load_family("centerpoint")
    with open(os.path.join(os.path.dirname(cp_weights.__file__), "configs",
                           "centerpoint-voxel0075-nus.json")) as fh:
        limits = json.load(fh)["check"]["limits"]
    numbers = fam.compare([(host, want)], _cd(small_config()))
    assert numbers["box_pairs"] > 0
    for name in fam.NAMES:
        assert numbers[name] <= limits[name], (name, numbers)


def test_spans_and_counters(f32_step):
    _, out, _, want, records = f32_step
    assert records
    rec = records[-1]
    for name in ("step", "push", "backbone3d", "voxelize", "plan", "dense",
                 "post", "nms", "fetch"):
        assert name in rec["spans"], name
    c = rec["counters"]
    assert c["cp.points"] == want["counts"]["points"]
    assert c["cp.voxels"] == want["counts"]["voxels"]
    assert c.get("cp.voxels_dropped", 0) == 0
    assert c["cp.candidates"] == want["counts"]["candidates"]
    assert c["nms.copies"] == 1
    assert c["nms.rows"] == 6 * 500


def test_benchmark_configuration_is_the_published_one():
    """The benchmark's configuration file holds CenterPointConfig's
    defaults (the published values and the port's capacities) whole."""
    with open(os.path.join(os.path.dirname(cp_weights.__file__), "configs",
                           "centerpoint-voxel0075-nus.json")) as fh:
        doc = json.load(fh)
    assert doc["reduced"] == []
    assert doc["config"] == _cd(CenterPointConfig())
    cfg = CenterPointConfig.from_dict(doc["config"])
    assert cfg == CenterPointConfig()
    assert cfg.data.grid_size == (1440, 1440, 40)
    assert cfg.data.sparse_shape == (1440, 1440, 41)
    assert cfg.class_labels == ((1,), (2, 3), (4, 5), (6,), (7, 8), (9, 10))


def test_nms_slots_equal_single():
    rng = np.random.default_rng(5)
    S, K = 6, 200
    xy = rng.uniform(-20, 20, (S, K, 2))
    dims = rng.uniform(0.5, 4.0, (S, K, 3))
    boxes = np.concatenate([xy, rng.uniform(-1, 1, (S, K, 1)), dims,
                            rng.uniform(-3, 3, (S, K, 1)),
                            rng.normal(size=(S, K, 2))], -1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (S, K)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, (S, K)) < 0.7)
    idx, mask = greedy_nms_slots(boxes, scores, valid, 0.2, 83)
    assert int(mask.sum()) > 6 * 20
    for s in range(S):
        i1, m1 = greedy_nms(boxes[s], scores[s], valid[s], 0.2, 83)
        assert torch.equal(m1, mask[s])
        assert torch.equal(i1[m1], idx[s][mask[s]])


def test_folded_block_bias_equals_explicit():
    rng = np.random.default_rng(9)
    dims = (40, 40, 9)
    c = torch.from_numpy(rng.integers(0, (40, 40, 9), (900, 3))).to(
        torch.int64)
    sites = Sites.unique(c, dims)
    n, C, cap = len(sites), 16, 1024
    feats = torch.from_numpy(rng.normal(size=(n, C)).astype(np.float32))
    sd = {}
    for k in (1, 2):
        sd[f"b.conv{k}.w"] = torch.from_numpy(
            rng.normal(0, 0.1, (27, C, C)).astype(np.float32))
        sd[f"b.conv{k}.b"] = torch.from_numpy(
            rng.normal(0, 0.5, C).astype(np.float32))
        sd[f"b.bn{k}.scale"] = torch.from_numpy(
            rng.uniform(0.8, 1.2, C).astype(np.float32))
        sd[f"b.bn{k}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, C).astype(np.float32))
        sd[f"b.bn{k}.mean"] = torch.from_numpy(
            rng.normal(0, 0.3, C).astype(np.float32))
        sd[f"b.bn{k}.var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, C).astype(np.float32))
    want = ref._res_block(Net(sd, "float32"), T(sites, feats), "b", None)

    blk = BasicBlock(27, C, C, False, 1e-3, 0.01)
    folded = {k[2:]: v for k, v in fold_block_bias(
        {"x.conv1.0." + k[2:]: v for k, v in sd.items()}).items()}
    assert not any(k.endswith(".b") for k in folded)
    blk.load_state_dict({k.replace("conv1.0.", ""): v
                         for k, v in folded.items()})
    keys = torch.full((cap,), 2**31 - 1, dtype=torch.int32)
    keys[:n] = sites.keys.to(torch.int32)
    coords = torch.zeros((cap, 3), dtype=torch.int32)
    coords[:n] = sites.coords.to(torch.int32)
    valid = torch.arange(cap) < n
    f = torch.zeros((cap, C))
    f[:n] = feats
    x = Slab(keys, coords, valid[:, None], f, valid, dims, 1)
    (plan,) = make_span_plans(keys, [dict(out_coords=coords, out_valid=valid,
                                          kernel3=(3, 3, 3), in_dims=dims)])
    assert int(plan.n_overflow) == 0
    with torch.no_grad():
        got = basic_block_slab(blk, x, (3, 3, 3), plan, dtype="float32")
    np.testing.assert_allclose(got.feats[:n].numpy(), want.feats.numpy(),
                               rtol=0, atol=2e-5)
