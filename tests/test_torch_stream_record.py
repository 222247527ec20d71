"""The stream parity record (tests/torch_stream_record.py and
insmos_tpu_torch/tools/stream_record.py): the written KITTI sequences give
back the fixture streams exactly; the record script's writer and comparer
hold the port's predict_mos on the CPU against the JAX package's at a tiny
size; the comparer flags each kind of difference; the committed record is
the one the chip run expects."""

import dataclasses
import os

import numpy as np
import pytest

from insmos_tpu_torch.cli import predict_mos
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data import kitti
from insmos_tpu_torch.data.hdl64 import (_raycast_steps,
                                         make_fixed_frame_stream,
                                         make_pose_stream, make_stream)
from insmos_tpu_torch.pipeline import fixed_frame_transform
from insmos_tpu_torch.tools import stream_record as SR
from insmos_tpu_torch.utils.checkpoint import save_checkpoint_from_trees
from insmos_tpu_torch.utils.params import init_params

import torch_stream_record
from test_torch_model import port_config
from torch_port_common import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(seq_dir):
    scans = [kitti.read_point_cloud(f) for f in kitti.load_files(
        os.path.join(seq_dir, "velodyne"))]
    poses = kitti.lidar_poses_from_files(os.path.join(seq_dir, "poses.txt"),
                                         os.path.join(seq_dir, "calib.txt"))
    return scans, poses


def test_written_sequences_give_back_the_streams(tmp_path):
    """Read back as predict_mos reads them, the ref-exact sequence gives
    make_stream's scans and, from its poses, make_stream's transforms bit
    for bit; the straight-ego sequence, framed as --fixed-frame frames it,
    gives make_fixed_frame_stream."""
    cfg = Config().tiny(points=4096)
    n = 3
    SR.write_sequences(str(tmp_path), cfg, n, seed=1)
    scans, poses = _read(str(tmp_path / "00"))
    ref_scans, ref_tfs = make_stream(cfg, n, seed=1)
    _, ref_poses = make_pose_stream(cfg, n, seed=1)
    np.testing.assert_array_equal(poses, ref_poses)
    prev = None
    for s, p, rs, rtf in zip(scans, poses, ref_scans, ref_tfs):
        np.testing.assert_array_equal(s, rs)
        tf = (np.linalg.inv(p) @ (prev if prev is not None else p)).astype(
            np.float32)
        np.testing.assert_array_equal(tf, rtf)
        prev = p
    scans, poses = _read(str(tmp_path / "01"))
    ref_scans, ref_tfs, _ = make_fixed_frame_stream(cfg, n, seed=1)
    snap = None
    for s, p, rs, rtf in zip(scans, poses, ref_scans, ref_tfs):
        f, tf, snap = fixed_frame_transform(s, p, snap, 0.1)
        np.testing.assert_array_equal(f, rs)
        np.testing.assert_allclose(tf, rtf, atol=1e-6)


def _port_rows(cfg, workdir, route="float32"):
    """The port's predict_mos over both sequences under ``workdir`` (as
    jax_record wrote them), on the CPU, summarized."""
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype=route))
    ckpt = os.path.join(workdir, f"port_ckpt_{route}")
    save_checkpoint_from_trees(ckpt, cfg, *init_params(
        cfg, np.random.default_rng(0)))
    out = os.path.join(workdir, f"port_out_{route}")
    rows = {}
    for name, (seq, fixed) in SR.SEQUENCES.items():
        with SR.capturing(predict_mos) as steps:
            predict_mos.main(
                ["--ckpt", ckpt, "--data_path", os.path.join(workdir, "kitti"),
                 "--sequences", str(seq), "--out", out, "--device", "cpu"]
                + (["--fixed-frame"] if fixed else []))
        rows[name] = SR.summarize(steps, os.path.join(out, cfg.experiment_id),
                                  seq)
    return rows


def _cropped_pose_stream(cfg, n_steps, seed=0, turn=True):
    """make_pose_stream with each scan cut to |x|, |y| < 6.6 m (sensor
    frame) before its points are permuted and cut to the tiny config's
    count, so that they fall in the tiny config's grid."""
    P = cfg.runtime.max_points_per_scan
    scans, poses = [], []
    for w, ego, scan, rng in _raycast_steps(n_steps, seed):
        pose = np.eye(4)
        pose[:2, 3] = ego
        scan_f = scan.astype(np.float32)
        if turn:
            c, s = np.cos(0.01 * w), np.sin(0.01 * w)
            pose[:2, :2] = [[c, -s], [s, c]]
            scan_f[:, :2] = scan_f[:, :2] @ np.float32([[c, s], [-s, c]]).T
        scan_f = scan_f[(np.abs(scan_f[:, 0]) < 6.6)
                        & (np.abs(scan_f[:, 1]) < 6.6)]
        n = min(len(scan_f), P)
        scans.append(scan_f[rng.permutation(len(scan_f))[:n]])
        poses.append(pose)
    return scans, np.stack(poses)


@pytest.fixture(scope="module")
def tiny_record(tmp_path_factory):
    """The record script at a tiny size (W=3, two scans past the first full
    window), and the port's predict_mos on the same sequences, cropped to
    the tiny grid."""
    cfg = port_config(tiny_config(window=3))
    work = str(tmp_path_factory.mktemp("record"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SR, "make_pose_stream", _cropped_pose_stream)
        record = torch_stream_record.jax_record(cfg, work, n_scans=5)
    path = os.path.join(work, "record.npz")
    SR.save_record(path, cfg, record, n_scans=5)
    return cfg, work, path, record, _port_rows(cfg, work)


@pytest.mark.parametrize("name", list(SR.SEQUENCES))
def test_port_matches_tiny_jax_record(tiny_record, name):
    cfg, work, path, record, rows = tiny_record
    res = SR.compare(record[name], rows[name], cfg.model.n_past_steps,
                     "float32")
    assert not res["failures"], res["failures"]
    assert res["compared"] == 5 and res["max_abs"] <= 1e-3
    assert all(s["counters_equal"] for s in res["steps"])
    assert all(s["boxes"] > 0 for s in res["steps"])
    # the record reads back as it was written
    cfg2, meta, back = SR.load_record(path)
    assert cfg2 == cfg and meta == {"n_scans": 5}
    assert list(back) == list(record)
    for a, b in zip(back[name], record[name]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_compare_flags_each_difference(tiny_record):
    cfg, _, _, record, rows = tiny_record
    W = cfg.model.n_past_steps
    ref = record["ref_exact"]

    def fails(edit):
        got = [dict(r) for r in rows["ref_exact"]]
        edit(got[-1])
        return SR.compare(ref, got, W, "float32")["failures"]

    assert not fails(lambda r: None)

    def logits(r):
        r["logits"] = r["logits"] + np.float32(0.3)

    def counter(r):
        r["voxelizer_out_of_range"] = r["voxelizer_out_of_range"] + 1

    def boxes(r):
        r["boxes"], r["scores"], r["labels"] = (r[k][:-1] for k in (
            "boxes", "scores", "labels"))

    def span(r):
        r["span_overflow"] = r["span_overflow"] + 1

    def counts(r):
        r["counts"] = r["counts"] + np.array([0, -50, 50])

    for edit, what in ((logits, "logits max abs"), (counter, "counters"),
                       (boxes, "kept boxes"), (span, "span_overflow"),
                       (counts, "label counts")):
        f = fails(edit)
        assert len(f) == 1 and what in f[0], (what, f)


def test_committed_record():
    """The committed record is at the full default Config in float32,
    holds both sequences of N_SCANS steps, fits in 2 MB, and its scans are
    those that write_sequences writes (point counts and samples)."""
    path = os.path.join(REPO, SR.RECORD)
    assert os.path.getsize(path) <= 2 * 2**20
    cfg, meta, record = SR.load_record(path)
    full = Config()
    assert cfg == dataclasses.replace(full, runtime=dataclasses.replace(
        full.runtime, compute_dtype="float32"))
    assert meta["n_scans"] == SR.N_SCANS
    assert list(record) == list(SR.SEQUENCES)
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
            assert r["span_overflow"].size == 0  # the JAX auto engine
            assert int(r["counts"].sum()) == len(s)
