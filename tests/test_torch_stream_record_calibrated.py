"""The calibrated stream record (tests/torch_stream_record.py --weights
calibrated and the calibrated functions of
insmos_tpu_torch/tools/stream_record.py): the record script's writer and
comparer hold the port's predict_mos on the CPU against the JAX package's
at a tiny size on calibrated tiny weights, boxes one to one and the
in-box logits; the comparer flags each kind of box and in-box difference;
the committed record and BN state are those the chip run expects."""

import dataclasses
import os

import numpy as np
import pytest

from insmos_tpu_torch.cli import predict_mos
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.hdl64 import make_pose_stream
from insmos_tpu_torch.tools import stream_record as SR
from insmos_tpu_torch.utils.checkpoint import save_checkpoint_from_trees
from insmos_tpu_torch.utils.params import _flatten, init_params

import torch_stream_record
from test_torch_model import port_config
from test_torch_stream_record import _cropped_pose_stream
from torch_port_common import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny scene is 12.8 m square: the class head's scale that puts a few
# candidates over the gate on most of its steps (the full Config's is
# SR.CLS_SCALE)
TINY_SCALE = 1.35


def tiny_trees(cfg):
    """Calibrated tiny weights: the recipe of calibrated_params at the
    tiny config, its BN statistics re-estimated over a window of the
    cropped stream (seed 7, not the record's)."""
    scans, _ = _cropped_pose_stream(cfg, cfg.model.n_past_steps, seed=7)
    W, P = len(scans), cfg.runtime.max_points_per_scan
    window = {"points": np.zeros((W, P, 4), np.float32),
              "num_points": np.array([len(s) for s in scans], np.int32),
              "scan_mask": np.ones(W, bool),
              "labels": np.ones((W, P), np.int32),
              "gt_boxes": np.zeros((cfg.model.head.max_objs, 8), np.float32),
              "num_boxes": np.int32(0)}
    for i, s in enumerate(scans):
        window["points"][i, :len(s)] = s
    params, _ = SR.head_params(cfg, TINY_SCALE)
    state = SR.estimate_calibrated_state(cfg, "cpu", window=window,
                                         scale=TINY_SCALE)
    return params, state


@pytest.fixture(scope="module")
def tiny_calibrated(tmp_path_factory):
    """The calibrated record script at a tiny size (W=3, 5 scans) on the
    fixed-frame sequence (the incremental mode; test_torch_stream_record
    runs both sequences through the same writer), and the port's
    predict_mos on it with the same weights, summarized against it."""
    cfg = port_config(tiny_config(window=3))
    work = str(tmp_path_factory.mktemp("calibrated"))
    trees = tiny_trees(cfg)
    sequences = {"fixed_frame": SR.SEQUENCES["fixed_frame"]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SR, "make_pose_stream", _cropped_pose_stream)
        mp.setattr(SR, "SEQUENCES", sequences)
        record = torch_stream_record.jax_record(cfg, work, n_scans=5,
                                                trees=trees)
    ckpt = os.path.join(work, "port_ckpt")
    save_checkpoint_from_trees(ckpt, cfg, *trees)
    out = os.path.join(work, "port_out")
    rows = {}
    for name, (seq, fixed) in sequences.items():
        with SR.capturing(predict_mos, SR.with_maps) as steps:
            predict_mos.main(
                ["--ckpt", ckpt, "--data_path", os.path.join(work, "kitti"),
                 "--sequences", str(seq), "--out", out, "--device", "cpu"]
                + (["--fixed-frame"] if fixed else []))
        rows[name] = SR.summarize_calibrated(
            cfg, steps, os.path.join(out, cfg.experiment_id), seq,
            record[name])
    return cfg, record, rows


def test_port_matches_tiny_calibrated_record(tiny_calibrated):
    cfg, record, rows = tiny_calibrated
    assert list(record) == list(rows) == ["fixed_frame"]
    res = SR.compare_calibrated(record["fixed_frame"], rows["fixed_frame"],
                                cfg.model.n_past_steps, "float32")
    assert not res["failures"], res["failures"]
    assert res["compared"] == 5
    assert res["max_abs"] <= 1e-3 and res["box_logit_abs"] <= 1e-3
    steps = res["steps"]
    assert sum(s["boxes"] for s in steps) >= 10
    assert sum(s["n_box_sample"] for s in steps) > 0
    assert all(s["n_gated"] == s["n_gated_got"] for s in steps)
    for r in record["fixed_frame"]:
        assert len(r["margins"]) == len(r["margins_circle"]) == len(
            r["boxes"])
        assert r["logits_box"].shape == (len(r["idx_box"]), 3)


def test_compare_calibrated_flags_each_difference(tiny_calibrated):
    cfg, record, rows = tiny_calibrated
    W = cfg.model.n_past_steps
    name = "fixed_frame"
    ref = record[name]
    assert len(ref[-1]["boxes"]) >= 2 and len(ref[-1]["idx_box"])
    assert (ref[-1]["margins"] >= 1e-6).sum() >= 2

    def fails(edit):
        got = [dict(r) for r in rows[name]]
        last = got[-1] = {k: np.array(v, copy=True)
                          for k, v in got[-1].items()}
        edit(last)
        return SR.compare_calibrated(ref, got, W, "float32")["failures"]

    assert not fails(lambda r: None)
    # port boxes in the record's order: a changed one is one the record
    # needs matched
    order = [int(np.abs(rows[name][-1]["scores"] - s).argmin())
             for s in ref[-1]["scores"]]
    need = [order[i] for i in np.flatnonzero(ref[-1]["margins"] >= 1e-6)]
    s = rows[name][-1]["scores"]
    a = need[0]
    b = max(need, key=lambda j: abs(float(s[j]) - float(s[a])))
    assert abs(float(s[b]) - float(s[a])) > 1e-3

    def dropped(r):
        for k in ("boxes", "scores", "labels"):
            r[k] = np.delete(r[k], a, axis=0)

    def swapped(r):
        r["scores"][[a, b]] = r["scores"][[b, a]]

    def duplicated(r):
        for k in ("boxes", "scores", "labels"):
            r[k][b] = r[k][a]

    def moved(r):
        r["boxes"][a, 0] += np.float32(2e-4)

    def in_box_logit(r):
        r["logits_box"][0, 0] += np.float32(2e-3)

    for edit, what in ((dropped, "kept boxes"), (swapped, "unmatched"),
                       (duplicated, "unmatched"), (moved, "unmatched"),
                       (in_box_logit, "in-box logits")):
        f = fails(edit)
        assert len(f) == 1 and what in f[0], (edit.__name__, f)


def test_committed_calibrated_state():
    """The committed BN state fills every leaf of init_params' state with
    finite statistics (variances positive), and calibrated_params puts it
    beside init_params' weights with the class head's bias and scale."""
    cfg = Config()
    params, state = SR.calibrated_params(cfg)
    p0, s0 = init_params(cfg, np.random.default_rng(0))
    got = _flatten(state, "", {})
    ref = _flatten(s0, "", {})
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].shape == v.shape and np.isfinite(got[k]).all(), k
        if k.endswith(".var"):
            assert (got[k] > 0).all(), k
    assert np.all(params["head"]["cls"]["b"] == np.float32(SR.CLS_BIAS))
    np.testing.assert_array_equal(
        params["head"]["cls"]["w"],
        p0["head"]["cls"]["w"] * np.float32(SR.CLS_SCALE))
    np.testing.assert_array_equal(params["motion"]["stem"]["conv"]["w"],
                                  p0["motion"]["stem"]["conv"]["w"])


def test_committed_calibrated_record():
    """The committed calibrated record is at the full default Config in
    float32 on calibrated_params' weights (its fingerprint), holds both
    sequences of N_SCANS steps, fits in 2 MB, its scans and samples are
    those that write_sequences writes, and the heatmap follows the scan:
    on every full-window step 8-200 gated candidates, a heatmap logit
    change of at least 0.1 from the step before, at most 5% of the kept
    boxes under the float32 margin, and a kept set that differs from the
    previous step's on at least half of those steps."""
    path = os.path.join(REPO, SR.RECORD_CALIBRATED)
    assert os.path.getsize(path) <= 2 * 2**20
    cfg, meta, record = SR.load_record(path)
    full = Config()
    assert cfg == dataclasses.replace(full, runtime=dataclasses.replace(
        full.runtime, compute_dtype="float32"))
    assert meta["n_scans"] == SR.N_SCANS and meta["weights"] == "calibrated"
    assert (meta["cls_bias"], meta["cls_scale"]) == (SR.CLS_BIAS,
                                                     SR.CLS_SCALE)
    assert meta["fingerprint"] == SR.fingerprint(*SR.calibrated_params(cfg))
    assert list(record) == list(SR.SEQUENCES)
    W = cfg.model.n_past_steps
    margin = SR.TOLERANCES_CALIBRATED["float32"]["margin"]
    for name, (seq, fixed) in SR.SEQUENCES.items():
        scans, _ = make_pose_stream(cfg, SR.N_SCANS, meta["seed"],
                                    turn=not fixed)
        rows = record[name]
        assert len(rows) == SR.N_SCANS
        for t, (r, s) in enumerate(zip(rows, scans)):
            assert int(r["n_raw"]) == len(s)
            np.testing.assert_array_equal(r["idx"],
                                          SR.sample_index(len(s), seq, t))
            assert r["logits"].shape == (SR.N_SAMPLE, 3)
            assert np.isfinite(r["logits"]).all()
            assert np.isfinite(r["logits_box"]).all()
            assert len(r["margins"]) == len(r["margins_circle"]) == len(
                r["boxes"])
            assert (r["margins_circle"] <= r["margins"]).all()
            assert int(r["counts"].sum()) == len(s)
        full_steps = rows[W - 1:]
        assert meta[f"{name}/heat_change"][W - 1:] == [
            float(r["heat_change"]) for r in full_steps]
        changed = meta[f"{name}/kept_changed"][W - 1:]
        assert sum(changed) >= len(changed) / 2
        for r in full_steps:
            assert 8 <= int(r["n_gated"]) <= 200
            assert float(r["heat_change"]) >= 0.1
            assert (r["margins"] < margin).sum() <= 0.05 * len(r["boxes"])
            assert len(r["idx_box"]) > 0
