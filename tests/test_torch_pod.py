"""Multi-stream (pod) inference: the port's PodInferencePipeline against
the JAX package's and against the port's own single-stream pipeline, and
``predict_mos --pod`` against the serial CLI.

Two sequences stream through two slots for four steps; slot 1 idles on the
third step and takes its next scan on the fourth, in both modes (ref-exact
on a turning ego, fixed-frame incremental on a moving one). Tiny config,
float32, the same numpy weights on both sides, on the CPU. Both pods run one
step vmapped over their slots. Against the JAX package's pod (one CPU
device, slots_per_device=2, its vmapped step on its windowed engine): point
logits within atol = rtol = 1e-4 (the JAX package's own pod-vs-single
tolerance), the overflow counters exactly, kept boxes as
tests/test_torch_model.py checks them. Against the port's single-stream
pipeline, which runs the same code on the same inputs one stream at a time:
every output equal. The NMS makes one device-to-host copy a pod step."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils import _pytree

from insmos_tpu.pipeline import PodInferencePipeline as JaxPod
from insmos_tpu_torch import obs
from insmos_tpu_torch.cli import predict_mos
from insmos_tpu_torch.data.synthetic import write_synthetic_sequence
from insmos_tpu_torch.pipeline import (InferencePipeline, PodInferencePipeline,
                                       fixed_frame_transform)
from insmos_tpu_torch.utils.checkpoint import save_checkpoint_from_trees
from insmos_tpu_torch.utils.params import init_params, make_model

from test_torch_model import _cmp_boxes, port_config
from torch_port_common import (fixed_frame_crop_stream, hdl64_crop_stream,
                               tiny_config)

N_STEPS = 4
IDLE = (2, 1)  # (step, slot): slot 1 idles on step 2
MODES = ("ref_exact", "incremental")


def _config(mode):
    cfg = tiny_config(window=3)
    if mode == "incremental":
        mn = dataclasses.replace(cfg.model.motionnet, stem_scan_capacity=2048)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, motionnet=mn),
            runtime=dataclasses.replace(cfg.runtime, incremental_stem=True))
    return cfg


def _streams(mode):
    """Two sequences of (scan, tf), one a slot."""
    out = []
    for seed in (0, 1):
        if mode == "incremental":
            raw, poses = fixed_frame_crop_stream(N_STEPS, seed=seed)
            prev, seq = None, []
            for r, p in zip(raw, poses):
                f, tf, prev = fixed_frame_transform(r, p, prev, 0.1)
                seq.append((f, tf))
        else:
            scans, tfs, _ = hdl64_crop_stream(N_STEPS, seed=seed)
            seq = list(zip(scans, tfs))
        out.append(seq)
    return out


def _schedule():
    """Per step, the stream index each slot takes (None: idle)."""
    nxt, rows = [0, 0], []
    for t in range(N_STEPS):
        row = []
        for i in range(2):
            if (t, i) == IDLE:
                row.append(None)
            else:
                row.append(nxt[i])
                nxt[i] += 1
        rows.append(row)
    return rows


def _inputs(streams, row):
    scans = [None if j is None else streams[i][j][0]
             for i, j in enumerate(row)]
    tfs = [None if j is None else streams[i][j][1]
           for i, j in enumerate(row)]
    return scans, tfs


def _bufs(pod, i):
    """Slot ``i``'s window and caches: its rows of the stacked buffer of
    the pod's one device."""
    return _pytree.tree_map(lambda t: t[i].clone(), pod._buf[0])


@pytest.fixture(scope="module", params=MODES)
def pod_run(request):
    mode = request.param
    cfg = _config(mode)
    pcfg = port_config(cfg)
    params, state = init_params(pcfg, np.random.default_rng(0))
    streams = _streams(mode)
    sched = _schedule()
    pod = PodInferencePipeline(pcfg, make_model(pcfg, params, state, "cpu"),
                               ["cpu"], slots_per_device=2)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1),
                (cfg.runtime.data_axis,))
    jpod = JaxPod(cfg, params, state, mesh=mesh, slots_per_device=2)
    got, ref, idle_before, idle_after, copies = [], [], None, None, []
    pod.reset()
    jpod.reset()
    for t, row in enumerate(sched):
        scans, tfs = _inputs(streams, row)
        if t == IDLE[0]:
            idle_before = _bufs(pod, IDLE[1])
        before = obs.counters()
        got.append(pod.push_scans(scans, tfs))
        copies.append(obs.since(before)["nms.copies"])
        if t == IDLE[0]:
            idle_after = _bufs(pod, IDLE[1])
        ref.append(jax.tree_util.tree_map(np.array,
                                          jpod.push_scans(scans, tfs)))
    single = []
    for i in range(2):
        pipe = InferencePipeline(pcfg, make_model(pcfg, params, state, "cpu"),
                                 "cpu")
        single.append([pipe.push_scan(s, tf) for s, tf in streams[i][
            :sum(r[i] is not None for r in sched)]])
    return dict(mode=mode, pcfg=pcfg, params=params, state=state,
                streams=streams, sched=sched, pod=pod, got=got, ref=ref,
                single=single, idle_before=idle_before,
                idle_after=idle_after, copies=copies)


def _slot(out, i):
    """Slot ``i``'s rows of batched port outputs, as torch tensors."""
    return {k: ({q: w[i] for q, w in v.items()} if k == "overflow" else v[i])
            for k, v in out.items()}


def _active(sched):
    return [(t, i, j) for t, row in enumerate(sched)
            for i, j in enumerate(row) if j is not None]


def _cmp_counters(mode, r, g):
    """The JAX window engine has no span plans and no decoder halos: its
    motion drops lead the port's (4 ref-exact, 5 incremental, with the
    maintained window's) and the port's other entries and every plan's
    coverage counter are 0; the voxelizer and UNet counters are equal."""
    md = g["motion_dropped"].numpy()
    n = len(r["motion_dropped"])
    assert n == (5 if mode == "incremental" else 4)
    np.testing.assert_array_equal(md[:n], r["motion_dropped"])
    assert (md[n:] == 0).all()
    assert int(g["span_overflow"].abs().sum()) == 0
    for k in ("voxelizer_dropped", "voxelizer_out_of_range",
              "voxelizer_capacity_dropped", "unet_dropped"):
        assert int(r[k]) == int(g[k]), k


@pytest.mark.parametrize("step", range(N_STEPS))
def test_pod_matches_jax_pod(pod_run, step):
    """Every active slot of the step (the idle step included)."""
    g_all, r_all = pod_run["got"][step], pod_run["ref"][step]
    active = [i for i, j in enumerate(pod_run["sched"][step])
              if j is not None]
    assert len(active) == (1 if step == IDLE[0] else 2)
    for i in active:
        g = _slot(g_all, i)
        r = {k: (v[i] if k != "overflow" else {q: w[i] for q, w in v.items()})
             for k, v in r_all.items()}
        np.testing.assert_allclose(g["point_logits"].numpy(),
                                   r["point_logits"], atol=1e-4, rtol=1e-4,
                                   err_msg=f"slot {i}")
        _cmp_counters(pod_run["mode"], r["overflow"], g["overflow"])
        _cmp_boxes(r, g)
        assert r["box_mask"].sum() > 0


def test_pod_slots_equal_single_stream(pod_run):
    """Each slot's outputs at each of its steps equal the port's
    single-stream pipeline's on the same stream, bit for bit."""
    n = 0
    for t, i, j in _active(pod_run["sched"]):
        g = _slot(pod_run["got"][t], i)
        s = pod_run["single"][i][j]
        for k in ("point_logits", "boxes", "scores", "labels", "box_mask"):
            assert torch.equal(g[k], s[k]), (t, i, k)
        for k, v in s["overflow"].items():
            assert torch.equal(g["overflow"][k], v), (t, i, k)
        n += 1
    assert n == 2 * N_STEPS - 1


def test_pod_nms_copies_once_a_step(pod_run):
    """The NMS of both slots made one device-to-host copy at every step."""
    assert pod_run["copies"] == [1] * N_STEPS


def test_idle_slot_keeps_its_window(pod_run):
    """The idle slot's window (and caches) are untouched, its rows zero,
    its box mask all False; the active slot stepped."""
    b, a = pod_run["idle_before"], pod_run["idle_after"]
    assert b.keys() == a.keys()
    if pod_run["mode"] == "incremental":
        assert {"stem_cache", "win"} <= set(a)
    for k in b:
        if isinstance(b[k], dict):
            for q in b[k]:
                assert torch.equal(b[k][q], a[k][q]), (k, q)
        else:
            assert torch.equal(b[k], a[k]), k
    out = _slot(pod_run["got"][IDLE[0]], IDLE[1])
    assert not out["box_mask"].any()
    assert not out["point_logits"].any()
    assert all(not v.any() for v in out["overflow"].values())


def test_pod_rejects_bad_inputs(pod_run):
    """A wrong slot count and an all-idle step raise; in the incremental
    mode so does a transform that is not an integer-voxel translation,
    before any slot steps (the pod has no full-stem recovery step)."""
    pod = PodInferencePipeline(
        pod_run["pcfg"], make_model(pod_run["pcfg"], pod_run["params"],
                                    pod_run["state"], "cpu"), ["cpu"], 2)
    s = pod_run["streams"][0][0][0]
    with pytest.raises(ValueError):
        pod.push_scans([s])
    with pytest.raises(ValueError):
        pod.push_scans([None, None])
    rot = np.eye(4, dtype=np.float32)
    rot[:2, :2] = [[np.cos(0.1), -np.sin(0.1)], [np.sin(0.1), np.cos(0.1)]]
    if pod_run["mode"] == "incremental":
        with pytest.raises(ValueError, match="slot 1"):
            pod.push_scans([s, s], [None, rot])
    assert pod._buf is None


def test_two_devices_place_slots_and_agree(pod_run):
    """devices=["cpu", "cpu"], one slot each: each device gets its own
    replica, its slot's stacked window and its own vmapped step, and the
    slots give the one-device pod's outputs."""
    pcfg = pod_run["pcfg"]
    model = make_model(pcfg, pod_run["params"], pod_run["state"], "cpu")
    pod = PodInferencePipeline(pcfg, model, ["cpu", "cpu"],
                               slots_per_device=1)
    assert pod.n_slots == 2 and pod.models[0] is model
    assert pod.models[1] is not model
    assert pod.devices == [torch.device("cpu")] * 2
    for t, row in enumerate(pod_run["sched"][:2]):
        out = pod.push_scans(*_inputs(pod_run["streams"], row))
        for k in ("point_logits", "scores", "box_mask"):
            assert torch.equal(out[k], pod_run["got"][t][k]), (t, k)


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """Two synthetic sequences of unequal length (the shorter one's slot
    idles on the last step) and a port checkpoint of tiny-config weights."""
    work = tmp_path_factory.mktemp("pod_cli")
    root = str(work / "kitti")
    for seq, n in ((8, 4), (9, 3)):
        write_synthetic_sequence(root, seq=seq, n_scans=n, seed=seq, n_ground=400,
                  n_per_obj=40)
    cfg = port_config(tiny_config(window=3))
    params, state = init_params(cfg, np.random.default_rng(1))
    ckpt = str(work / "ckpt")
    save_checkpoint_from_trees(ckpt, cfg, params, state)
    return dict(work=work, root=root, ckpt=ckpt, cfg=cfg)


@pytest.mark.parametrize("fixed", [False, True],
                         ids=["ref_exact", "fixed_frame"])
def test_pod_cli_matches_serial(cli_root, fixed):
    """predict_mos --pod --slots_per_device 2 writes the serial CLI's
    labels byte for byte."""
    work = cli_root["work"]
    tag = "ff" if fixed else "re"
    base = ["--ckpt", cli_root["ckpt"], "--data_path", cli_root["root"],
            "--sequences", "8", "9", "--device", "cpu"] + (
                ["--fixed-frame"] if fixed else [])
    out_a, out_b = str(work / f"serial_{tag}"), str(work / f"pod_{tag}")
    serial = predict_mos.main(base + ["--out", out_a])
    pod = predict_mos.main(base + ["--out", out_b, "--pod",
                                   "--slots_per_device", "2"])
    assert serial["scans"] == pod["scans"] == 7
    assert pod["waves"][0]["sequences"] == [8, 9]
    exp = cli_root["cfg"].experiment_id
    for seq, n in (("08", 4), ("09", 3)):
        for i in range(n):
            rel = f"{exp}/mos_preb/sequences/{seq}/predictions/{i:06d}.label"
            with open(f"{out_a}/{rel}", "rb") as fa, \
                    open(f"{out_b}/{rel}", "rb") as fb:
                a, b = fa.read(), fb.read()
            assert len(a) > 0 and a == b, rel
