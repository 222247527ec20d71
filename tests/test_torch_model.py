"""The whole slice: the port's streaming InferencePipeline and model
forward against the JAX package, tiny config, float32, identical weights.

On the CPU the JAX package serves with its plain reference engine (the
windowed XLA convs, ``sparse_engine="auto"``); the slow variant holds the
port against the JAX span engine run in interpret mode. Tolerances:
point logits atol = rtol = 1e-3 (as tests/test_span_conv.py holds the two
JAX engines; the float32 sums of ~30 convs run in other orders), dense
head maps 1e-4; every overflow counter exactly. Kept boxes are compared as
sets: two candidates whose scores differ by ~1e-7 may swap places in the
score order, which changes the order of the kept list but not its
contents."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from insmos_tpu.nn import InsMOSModel as JaxModel
from insmos_tpu.pipeline import InferencePipeline as JaxPipeline
from insmos_tpu_torch import config as port_config_mod
from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.utils.params import init_params, make_model

from torch_port_common import hdl64_crop_stream, tiny_config

N_SCANS = 4


def port_config(cfg):
    """The port's Config holding the same values as the JAX package's."""
    def build(obj):
        cls = getattr(port_config_mod, type(obj).__name__)
        return cls(**{f.name: (build(getattr(obj, f.name))
                               if dataclasses.is_dataclass(getattr(obj, f.name))
                               else getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return build(cfg)


def _run(engine):
    cfg = tiny_config(window=4, engine=engine)
    pcfg = port_config(cfg)
    params, state = init_params(pcfg, np.random.default_rng(0))
    scans, tfs, poses = hdl64_crop_stream(N_SCANS)
    port = InferencePipeline(pcfg, make_model(pcfg, params, state, "cpu"),
                             "cpu")
    got = [port.push_scan(s, tf) for s, tf in zip(scans, tfs)]
    ref_pipe = JaxPipeline(cfg, params, state)
    ref = [jax.tree_util.tree_map(np.asarray, ref_pipe.push_scan(s, tf))
           for s, tf in zip(scans, tfs)]
    return cfg, params, state, scans, poses, port, ref_pipe, got, ref


@pytest.fixture(scope="module")
def window_run():
    return _run("auto")


def _cmp_boxes(r, g):
    rm, gm = r["box_mask"].astype(bool), g["box_mask"].numpy()
    np.testing.assert_array_equal(rm, gm)
    rb, gb = r["boxes"][rm], g["boxes"].numpy()[gm]
    rs, gs = r["scores"][rm], g["scores"].numpy()[gm]
    d = np.abs(rb[:, None, :] - gb[None, :, :]).max(-1)  # (nr, ng)
    match = d.argmin(1)
    assert (d.min(1) <= 1e-3).all() and len(set(match)) == len(match)
    np.testing.assert_allclose(gs[match], rs, atol=1e-5)
    np.testing.assert_array_equal(g["labels"].numpy()[gm][match],
                                  r["labels"][rm])


def _cmp_common(r, g):
    np.testing.assert_allclose(g["point_logits"].numpy(), r["point_logits"],
                               atol=1e-3, rtol=1e-3)
    ro, go = r["overflow"], g["overflow"]
    for k in ("voxelizer_dropped", "voxelizer_out_of_range",
              "voxelizer_capacity_dropped", "unet_dropped"):
        assert int(ro[k]) == int(go[k]), k
    _cmp_boxes(r, g)


@pytest.mark.parametrize("step", range(N_SCANS))
def test_pipeline_matches_jax_window_engine(window_run, step):
    *_, got, ref = window_run
    r, g = ref[step], got[step]
    _cmp_common(r, g)
    assert r["box_mask"].sum() > 0
    # the window engine has no span plans and no decoder halos: the port's
    # extra counters (3 halo capacities, every plan's coverage) must be 0
    md = g["overflow"]["motion_dropped"].numpy()
    np.testing.assert_array_equal(md[:4], r["overflow"]["motion_dropped"])
    assert (md[4:] == 0).all() and len(md) == 7
    assert "span_overflow" not in r["overflow"]
    assert int(g["overflow"]["span_overflow"].abs().sum()) == 0


def test_stream_sequence_matches_push_scan(window_run):
    cfg, params, state, scans, poses, port, _, got, _ = window_run
    outs = list(port.stream_sequence(iter(scans), poses))
    assert len(outs) == N_SCANS
    for o, g, s in zip(outs, got, scans):
        np.testing.assert_allclose(o["point_logits"],
                                   g["point_logits"][: len(s)].numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert len(o["boxes"]) == int(g["box_mask"].sum())


def test_infer_window_matches_jax(window_run):
    """The window interface: a reset, then the scans pushed untracked."""
    scans, port, ref_pipe = window_run[3], window_run[5], window_run[6]
    g = port.infer_window(scans[:3])
    r = ref_pipe.infer_window(scans[:3])
    np.testing.assert_allclose(g["point_logits"], r["point_logits"],
                               atol=1e-3, rtol=1e-3)
    assert g["point_logits"].shape == (len(scans[2]), 3)
    assert len(g["boxes"]) == len(r["boxes"]) > 0


def test_model_forward_matches_jax(window_run):
    """One window through both models' forward: the MotionNet output, the
    dense head maps and the point logits."""
    cfg, params, state, *_ = window_run
    buf = {k: v for k, v in window_run[5]._buf.items()}
    sample = {k: v.numpy() for k, v in buf.items()}
    jm = JaxModel(cfg)
    jsample = dict(sample, labels=np.zeros(sample["points"].shape[:2],
                                           np.int32),
                   gt_boxes=np.zeros((cfg.model.head.max_objs, 8), np.float32),
                   num_boxes=np.int32(0))
    fwd = jax.jit(lambda p, s, x: jm.forward(p, s, x, train=False))
    ref = jax.tree_util.tree_map(np.asarray, fwd(params, state, jsample))
    model = make_model(port_config(cfg), params, state, "cpu")
    got = model({k: torch.from_numpy(v) for k, v in sample.items()})
    np.testing.assert_allclose(got["motion_logits"].numpy(),
                               ref["motion_logits"], atol=1e-4, rtol=1e-4)
    for k in ("cls_map", "box_map"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=1e-4,
                                   rtol=1e-4)
    _cmp_common(ref, got)


@pytest.mark.slow
def test_pipeline_matches_jax_span_engine():
    """Against the JAX span engine (Pallas interpret mode): the same plans,
    so every counter, span overflow and decoder halo included, matches."""
    *_, got, ref = _run("span")
    for r, g in zip(ref, got):
        _cmp_common(r, g)
        np.testing.assert_array_equal(g["overflow"]["motion_dropped"].numpy(),
                                      r["overflow"]["motion_dropped"])
        np.testing.assert_array_equal(g["overflow"]["span_overflow"].numpy(),
                                      r["overflow"]["span_overflow"])
