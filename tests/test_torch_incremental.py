"""The fixed-frame incremental streaming mode: the port against the JAX
package, and the port's incremental pipeline against its own direct one.

Integer arrays (the maintained site set, its occupancy and rows, the
stem-scan plan, the streams) are compared exactly, and so is the re-rowed
stem cache, which is only moved. The pipelines run a small crop of the
HDL-64E fixture with a moving ego, tiny config, float32, identical weights:
against the JAX package (its plain window engine on the CPU; the slow
variant its span engine in interpret mode) point logits agree within
atol = rtol = 1e-3 and every overflow counter exactly, as in
tests/test_torch_model.py; against the port's direct pipeline, which
computes the same sums on the same site sets, within 1e-4."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insmos_tpu.config import Config as JaxConfig
from insmos_tpu.pipeline import InferencePipeline as JaxPipeline
from insmos_tpu.pipeline import fixed_frame_transform as jax_fixed_frame
from insmos_tpu.sparse import slab as js
from insmos_tpu.sparse import span_conv as jsc
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.hdl64 import make_fixed_frame_stream, make_stream
from insmos_tpu_torch.nn.minkunet4d import PLAN_BUDGETS
from insmos_tpu_torch.pipeline import InferencePipeline, fixed_frame_transform
from insmos_tpu_torch.sparse import slab as ts
from insmos_tpu_torch.sparse import span_conv as tsc
from insmos_tpu_torch.utils.params import init_params, make_model

from test_torch_model import _cmp_common, port_config
from torch_port_common import fixed_frame_crop_stream, tiny_config

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import bench  # noqa: E402

N_SCANS = 5  # window 4: the last step drops the oldest scan
_SENT = ts.KEY_SENTINEL


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ------------------------------------------------------- maintain_window_slab
# name, seed, dims, W, prev points, new points, capacity, shift
MAINTAIN_CASES = [
    ("shift_out_of_grid", 0, (40, 32, 12), 4, 1500, 500, 2048, (7, -3, 1)),
    ("capacity_overflow", 1, (40, 32, 12), 3, 1200, 900, 1024, (-2, 1, 0)),
    ("no_shift", 2, (24, 20, 10), 4, 700, 300, 1024, (0, 0, 0)),
]


_jax_build_slab = jax.jit(js.build_slab, static_argnums=(3, 4, 5))
_jax_maintain = jax.jit(js.maintain_window_slab,
                        static_argnums=(6, 7, 8, 9))


@pytest.mark.parametrize("case", MAINTAIN_CASES, ids=[c[0] for c in
                                                      MAINTAIN_CASES])
def test_maintain_window_slab_matches_jax(case):
    _, seed, dims, W, n_prev, n_new, cap, shift = case
    rng = np.random.default_rng(seed)
    C = 3
    c3 = np.stack([rng.integers(0, d, n_prev) for d in dims], -1)
    prev, _, _, _ = _jax_build_slab(
        jnp.asarray(c3, jnp.int32),
        jnp.asarray(rng.integers(0, W, n_prev), jnp.int32),
        jnp.ones(n_prev, bool), dims, W, cap)
    stem = rng.normal(size=(cap, W * C)).astype(np.float32)
    c3n = np.stack([rng.integers(0, d, n_new) for d in dims], -1)
    scan, _, _, _ = _jax_build_slab(
        jnp.asarray(c3n, jnp.int32), jnp.zeros(n_new, jnp.int32),
        jnp.ones(n_new, bool), dims, 1, n_new)
    sh = np.asarray(shift, np.int32)
    ref = _jax_maintain(prev.keys, prev.occ, jnp.asarray(stem),
                                  scan.keys, scan.valid, jnp.asarray(sh),
                                  dims, W, C, cap)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = ts.maintain_window_slab(t(prev.keys), t(prev.occ), t(stem),
                                  t(scan.keys), t(scan.valid), t(sh), dims,
                                  W, C, cap)
    for what, r, g in zip(("keys", "coords", "occ", "stem_shifted", "new_pos",
                           "n_sites", "n_dropped"), ref, got):
        _eq(r, g, what)
    # the cases reach what they are named for
    pk = np.asarray(prev.keys)
    live = (pk != _SENT) & np.asarray(prev.occ)[:, 1:].any(1)
    moved = np.asarray(js.delinearize3(jnp.asarray(pk), dims))[live] - sh
    leaves = ((moved < 0) | (moved >= np.asarray(dims))).any(1).sum()
    if case[0] == "shift_out_of_grid":
        assert leaves > 0
    if case[0] == "capacity_overflow":
        assert int(got[6]) > 0


def test_maintained_set_lacks_points_entering_the_grid():
    """The reference's semantics, which the port keeps: the maintained set
    is the rebuilt window union minus the sites of window points that were
    outside the grid before the shift (they enter the crop as the ego
    moves; on the full fixture stream 70-803 sites a step, ROADMAP Queue
    3)."""
    rng = np.random.default_rng(4)
    dims, W, cap, n = (30, 24, 8), 3, 4096, 900
    shift = np.int32([5, 0, 0])  # previous-frame coords = new + shift
    c3 = np.stack([rng.integers(0, d + 6, n) for d in dims], -1).astype(
        np.int32)
    tc = rng.integers(0, W, n).astype(np.int32)
    ones = lambda k: torch.ones(k, dtype=torch.bool)  # noqa: E731
    prev, _, _, _ = ts.build_slab(torch.from_numpy(c3), torch.from_numpy(tc),
                                  ones(n), dims, W, cap)
    scan, _, _, _ = ts.build_slab(torch.zeros((1, 3), dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32), ones(1),
                                  dims, 1, 64)
    keys = ts.maintain_window_slab(
        prev.keys, prev.occ, torch.zeros((cap, W)), scan.keys, scan.valid,
        torch.from_numpy(shift), dims, W, 1, cap)[0]
    # the rebuild: every point shifted into the new frame, one slot older
    live = tc >= 1
    pts = np.concatenate([c3[live] - shift, np.zeros((1, 3), np.int32)])
    rebuilt, _, _, _ = ts.build_slab(
        torch.from_numpy(pts), torch.zeros(len(pts), dtype=torch.int32),
        ones(len(pts)), dims, 1, cap)
    got = set(keys[keys != _SENT].tolist())
    full = set(rebuilt.keys[rebuilt.valid].tolist())
    was_out = ((c3[live] < 0) | (c3[live] >= np.asarray(dims))).any(1)
    entering = ts.linearize3(torch.from_numpy(c3[live][was_out] - shift),
                             dims)
    entering = set(entering[entering != _SENT].tolist())
    assert got <= full and len(entering) > 0
    assert full - got == entering - got


# --------------------------------------------------- framing and the streams
def test_fixed_frame_transform_matches_jax():
    rng = np.random.default_rng(3)
    prev = None
    for i in range(3):
        scan = rng.normal(0, 20, (500, 4)).astype(np.float32)
        a = 0.3 * i + 0.1
        pose = np.eye(4)
        pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        pose[:3, 3] = rng.normal(0, 30, 3)
        ref = jax_fixed_frame(scan, pose, prev, 0.1)
        got = fixed_frame_transform(scan, pose, prev, 0.1)
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype
            np.testing.assert_array_equal(r, g)
        prev = ref[2]


@pytest.mark.parametrize("fixed_frame", [True, False],
                         ids=["fixed_frame", "ref_exact"])
def test_streams_match_bench(fixed_frame):
    """The port's streams against bench.make_stream: the fixed-frame one
    (bench's headline) and the ref-exact one, bit for bit."""
    n, seed = 3, 1
    jcfg, pcfg = JaxConfig(), Config()
    scans, ns, tfs, shifts = bench.make_stream(jcfg, n, seed=seed,
                                               ref_exact=not fixed_frame)
    if fixed_frame:
        p_scans, p_tfs, p_shifts = make_fixed_frame_stream(pcfg, n, seed)
        for r, g in zip(shifts, p_shifts):
            _eq(r, g, "shift")
        assert any(s.any() for s in p_shifts)
    else:
        p_scans, p_tfs = make_stream(pcfg, n, seed)
    for pad, k, g in zip(scans, ns, p_scans):
        _eq(pad[:k], g, "scan")
        assert not pad[k:].any()
    for r, g in zip(tfs, p_tfs):
        _eq(r, g, "tf")


def test_stem_scan_plan_matches_jax():
    """The T=1 stem-scan plan on the full default config's grid with the
    reference's literal budgets, over a fixture scan in the fixed frame
    cut to |x|, |y| < 6 m (~11k sites; the JAX plan at the full 65,536-row
    capacity takes ~25 s on the CPU)."""
    pcfg = Config()
    mc = pcfg.model.motionnet
    scans, _, _ = make_fixed_frame_stream(pcfg, 2, seed=0)
    s = scans[1][(np.abs(scans[1][:, 0]) < 6) & (np.abs(scans[1][:, 1]) < 6)]
    c3 = np.floor((s[:, :3] - np.float32(mc.crop_range[:3]))
                  * 10.0).astype(np.int32)
    n, cap, dims = len(c3), 16384, mc.grid_size
    jslab, _, _, _ = js.build_slab(jnp.asarray(c3), jnp.zeros(n, jnp.int32),
                                   jnp.ones(n, bool), dims, 1, cap)
    tslab, _, _, _ = ts.build_slab(torch.from_numpy(c3),
                                   torch.zeros(n, dtype=torch.int32),
                                   torch.ones(n, dtype=torch.bool), dims, 1,
                                   cap)
    for f in ("keys", "coords", "occ", "valid"):
        _eq(getattr(jslab, f), getattr(tslab, f), f)
    assert 0 < int(tslab.valid.sum()) < cap
    jp = jsc.make_span_plan(jslab.keys, jslab.coords, jslab.valid, (5, 5, 5),
                            in_dims=dims, span=192, slots=3072, gwin=40,
                            pairs=2560)
    tp = tsc.make_span_plan(tslab.keys, tslab.coords, tslab.valid, (5, 5, 5),
                            in_dims=dims, **PLAN_BUDGETS["stem_scan"])
    for f in ("sb", "se", "emp", "gp", "gs", "n_overflow"):
        _eq(getattr(jp, f), getattr(tp, f), f)
    assert int((tp.gs[1] >= 0).sum()) > 0  # coverage slots in use


# ---------------------------------------------------------------- pipelines
def _configs(engine="auto"):
    cfg = tiny_config(window=4, engine=engine)
    mn = dataclasses.replace(cfg.model.motionnet, stem_scan_capacity=2048)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, motionnet=mn))
    cfg_inc = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, incremental_stem=True))
    return cfg, cfg_inc


def _fixed(scans, poses):
    out, prev = [], None
    for s, p in zip(scans, poses):
        f, tf, prev = fixed_frame_transform(s, p, prev, 0.1)
        out.append((f, tf))
    return out


def _rotz(a):
    tf = np.eye(4, dtype=np.float32)
    tf[:2, :2] = np.float32([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return tf


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # copies: buffers are donated


def _run(engine, with_port_direct=True):
    cfg, cfg_inc = _configs(engine)
    pcfg, pcfg_inc = port_config(cfg), port_config(cfg_inc)
    params, state = init_params(pcfg, np.random.default_rng(0))
    raw, poses = fixed_frame_crop_stream(N_SCANS)
    framed = _fixed(raw, poses)
    inc = InferencePipeline(pcfg_inc, make_model(pcfg_inc, params, state,
                                                 "cpu"), "cpu")
    ref_pipe = JaxPipeline(cfg_inc, params, state)
    run = dict(raw=raw, poses=poses, framed=framed, got=[], ref=[],
               win_before=[], caches=[], pcfg_inc=pcfg_inc, params=params,
               state=state, inc=inc)
    for f, tf in framed:
        run["win_before"].append(inc._buf["win"] if inc._buf else None)
        run["got"].append(inc.push_scan(f, tf))
        run["ref"].append(_np(ref_pipe.push_scan(f, tf)))
        run["caches"].append((dict(inc._buf), _np(ref_pipe._buf)))
    if not with_port_direct:
        return run
    direct = InferencePipeline(pcfg, make_model(pcfg, params, state, "cpu"),
                               "cpu")
    run["direct"] = [direct.push_scan(f, tf) for f, tf in framed]
    run["n_full"] = [inc.n_full_steps]
    # a rotation: the recovery step; then an integer shift: incremental
    tf_shift = np.eye(4, dtype=np.float32)
    tf_shift[:3, 3] = np.float32([3, -2, 1]) * np.float32(0.1)
    for scan, tf in ((framed[0][0], _rotz(0.3)), (framed[1][0], tf_shift)):
        run["got"].append(inc.push_scan(scan, tf))
        run["direct"].append(direct.push_scan(scan, tf))
        run["n_full"].append(inc.n_full_steps)
    return run


@pytest.fixture(scope="module")
def inc_run():
    return _run("auto")


def _cmp_counters(r, g):
    """The JAX window engine has no span plans and no decoder halos: its
    motion drops are (scan slab, maintained window, 3 levels); the port's
    3 halo capacities and every plan's coverage counter must be 0."""
    md = g["overflow"]["motion_dropped"].numpy()
    assert len(md) == 8
    np.testing.assert_array_equal(md[:5], r["overflow"]["motion_dropped"])
    assert (md[5:] == 0).all()
    assert "span_overflow" not in r["overflow"]
    so = g["overflow"]["span_overflow"]
    assert int(so.abs().sum()) == 0


@pytest.mark.parametrize("step", range(N_SCANS))
def test_incremental_matches_jax(inc_run, step):
    r, g = inc_run["ref"][step], inc_run["got"][step]
    _cmp_common(r, g)
    _cmp_counters(r, g)
    # the carried caches: the window site set exactly, the stem cache in
    # float32 (as the JAX package stores it) within the stem's tolerance
    pb, jb = inc_run["caches"][step]
    for k in ("keys", "occ"):
        _eq(jb["win"][k], pb["win"][k], f"win {k}")
    _eq(jb["stem_cache"]["keys"], pb["stem_cache"]["keys"], "cache keys")
    rf, gf = jb["stem_cache"]["feats"], pb["stem_cache"]["feats"]
    assert rf.dtype == np.float32 and gf.dtype == torch.float32
    np.testing.assert_allclose(gf.numpy(), rf, atol=1e-5, rtol=1e-5)


def test_moving_ego_drops_sites_leaving_the_grid(inc_run):
    """The stream shifts the window by non-zero integer voxels every step,
    and live sites of the previous window leave the grid."""
    pcfg = inc_run["pcfg_inc"]
    dims = pcfg.model.motionnet.grid_size
    left = 0
    for step in range(1, N_SCANS):
        _, tf = inc_run["framed"][step]
        k = np.round(tf[:3, 3] / 0.1).astype(np.int32)
        assert k.any()
        win = inc_run["win_before"][step]
        live = (win["keys"] != _SENT) & win["occ"][:, 1:].any(1)
        c = ts.delinearize3(win["keys"][live], dims) + torch.from_numpy(k)
        left += int(((c < 0) | (c >= torch.tensor(dims))).any(1).sum())
    assert left > 0


@pytest.mark.parametrize("step", range(N_SCANS + 2))
def test_incremental_matches_direct(inc_run, step):
    """Every step, warm-up included; then a rotation takes the recovery
    step (n_full_steps 1) and an integer shift returns to the incremental
    path (n_full_steps stays 1)."""
    g, d = inc_run["got"][step], inc_run["direct"][step]
    for k in ("point_logits", "scores"):
        np.testing.assert_allclose(g[k].numpy(), d[k].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(g["box_mask"].numpy(),
                                  d["box_mask"].numpy())
    assert inc_run["n_full"] == [0, 1, 1]


def test_stream_sequence_fixed_frame_matches_push_scan(inc_run):
    pipe = InferencePipeline(
        inc_run["pcfg_inc"], make_model(inc_run["pcfg_inc"], inc_run["params"],
                                        inc_run["state"], "cpu"), "cpu")
    outs = list(pipe.stream_sequence(iter(inc_run["raw"]), inc_run["poses"],
                                     fixed_frame=True))
    assert len(outs) == N_SCANS and pipe.n_full_steps == 0
    for o, g, s in zip(outs, inc_run["got"], inc_run["raw"]):
        np.testing.assert_allclose(o["point_logits"],
                                   g["point_logits"][:len(s)].numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert len(o["boxes"]) == int(g["box_mask"].sum())


def test_unmaintained_incremental_stem_matches_maintained(inc_run):
    """The stem cache without the window cache: the window site set is
    built from the points and the cache is key-matched onto it. The last
    step of the stream, from the caches of the step before."""
    pipe = inc_run["inc"]
    model = pipe.model
    prev, _ = inc_run["caches"][N_SCANS - 2]
    f, tf = inc_run["framed"][N_SCANS - 1]
    k = np.round(tf[:3, 3] / 0.1)
    tf_snap = torch.eye(4)
    tf_snap[:3, 3] = torch.from_numpy((k * 0.1).astype(np.float32))
    P = inc_run["pcfg_inc"].runtime.max_points_per_scan
    padded = torch.zeros((P, 4))
    padded[:len(f)] = torch.from_numpy(f)
    pts, num, mask = pipe._roll_window(prev, padded, len(f), tf_snap)
    sample = {"points": pts, "num_points": num, "scan_mask": mask}
    shift = torch.from_numpy(-k.astype(np.int32))
    a = model.forward_motion(sample, stem_cache=prev["stem_cache"],
                             win_cache=prev["win"], cache_shift=shift)
    b = model.forward_motion(sample, stem_cache=prev["stem_cache"],
                             cache_shift=shift)
    np.testing.assert_allclose(b["motion_cur"].numpy(),
                               a["motion_cur"].numpy(), atol=1e-5, rtol=1e-5)
    for part in ("win", "stem_cache"):
        _eq(a[part]["keys"], b[part]["keys"], f"{part} keys")
    _eq(a["win"]["occ"], b["win"]["occ"], "occ")
    np.testing.assert_allclose(b["stem_cache"]["feats"].numpy(),
                               a["stem_cache"]["feats"].numpy(), atol=1e-5,
                               rtol=1e-5)
    # the scan plan's counter comes first in the maintained branch, last
    # in this one
    sa = [int(v) for v in a["motion_span_overflow"]]
    sb = [int(v) for v in b["motion_span_overflow"]]
    assert sb == sa[1:] + sa[:1] and len(sa) == 10


@pytest.mark.slow
def test_incremental_matches_jax_span_engine():
    """Against the JAX span engine (Pallas interpret mode): the same plans,
    so the per-plan span_overflow vector and every drop counter match
    exactly."""
    run = _run("span", with_port_direct=False)
    for r, g in zip(run["ref"], run["got"]):
        _cmp_common(r, g)
        _eq(r["overflow"]["motion_dropped"], g["overflow"]["motion_dropped"],
            "motion_dropped")
        _eq(r["overflow"]["span_overflow"], g["overflow"]["span_overflow"],
            "span_overflow")
