"""Stream parity against a committed record of the JAX package.

The JAX package cannot run beside the port on the card, so its
``predict_mos`` is run elsewhere (``tests/torch_stream_record.py``, on the
CPU) over two KITTI-format sequences of the HDL-64E raycast fixture and
condensed into a record, ``tests/torch_goldens/stream_record.npz``. This
module holds everything of that comparison that needs no jax, for the
record script and for ``chip_smoke.py`` alike:

- :data:`SEQUENCES`: the ref-exact stream (turning ego, sequence 00) and
  the straight-ego stream that ``--fixed-frame`` frames itself (sequence
  01), both written by :func:`write_sequences`;
- :func:`capturing`: the step outputs of a ``predict_mos`` run, taken from
  its pipeline's ``push_scan``;
- :func:`summarize`: per step, the raw point logits at a fixed seeded
  sample of points, every overflow counter, the per-class counts of the
  written ``.label`` artifact and the kept boxes of the bbox artifact;
- :func:`compare`: the port's summary against the record's, within the
  tolerances of :data:`TOLERANCES`.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from ..config import Config
from ..data.hdl64 import make_pose_stream
from ..data.kitti import load_files, write_sequence

RECORD = os.path.join("tests", "torch_goldens", "stream_record.npz")
# name -> (sequence number, --fixed-frame)
SEQUENCES = {"ref_exact": (0, False), "fixed_frame": (1, True)}
N_SCANS = 12
N_SAMPLE = 1024
# counters that both packages return; motion_dropped is compared over the
# JAX window engine's entries, and every further entry of the port's
# (decoder halos) and its span_overflow must be 0
COUNTERS = ("voxelizer_dropped", "voxelizer_out_of_range",
            "voxelizer_capacity_dropped", "unet_dropped")

# Per route (the record is float32): the largest |logit - record| over the
# sampled points of the compared steps and the largest share of them beyond
# 1e-3; the largest change of a per-class label count, as a share of the
# scan's points; and the kept boxes: equal in number, each record box
# matched by a port box within ``box_abs`` (its 7 parameters and its score),
# at most ``box_unmatched_share`` of them unmatched.
# Both routes repeat bit for bit from run to run on the card (the voxel
# mean sums in point order, sparse/voxelize.py), so each bound is set from
# the readings of the full default Config on an NVIDIA H100 (the warm-up
# steps with span overflow not compared). float32: logits within 1.04e-7,
# label counts equal, matched boxes within 7.6e-6. With the random weights
# the head's scores are nearly flat (the 500 kept boxes of a step within
# 5e-4 of each other, ~6e-8 apart), so the order in which greedy NMS visits
# them, and so which 500 of the ~4k candidates it keeps, turns on the last
# bits of the scores: 0-65 of 500 kept boxes differ from the record's. The
# instance fusion reads the kept boxes and can move the logits of points
# near a changed box (on a cut of the scene, by up to 0.027); no sampled
# point of this record lies near one. bf16 rounds every conv's operands to
# 8 bits of mantissa, which moves the scores by more than their whole
# spread: 240-385 of the 500 kept boxes differ, matched ones within 0.0021,
# logits within 0.078 with at most 0.62% of the sampled points beyond 1e-3,
# one label of a scan changed.
TOLERANCES = {
    "float32": dict(logit_abs=1e-4, share_over_1e_3=0.0, count_share=1e-4,
                    box_abs=1e-4, box_unmatched_share=0.2),
    "bfloat16": dict(logit_abs=0.2, share_over_1e_3=0.02, count_share=1e-3,
                     box_abs=0.01, box_unmatched_share=0.85),
}


def write_sequences(root: str, cfg: Config, n_scans: int = N_SCANS,
                    seed: int = 0) -> None:
    """Both fixture sequences under ``root`` (``00``, ``01``), with scans
    cut to ``cfg``'s points per scan."""
    for name, (seq, fixed) in SEQUENCES.items():
        scans, poses = make_pose_stream(cfg, n_scans, seed, turn=not fixed)
        write_sequence(os.path.join(root, f"{seq:02d}"), scans, poses)


@contextlib.contextmanager
def capturing(cli_module):
    """Within the block, every pipeline that ``cli_module`` (a predict_mos
    module) builds appends each step's outputs and its scan's point count
    to the yielded list. The outputs stay where the pipeline put them."""
    steps = []
    orig = cli_module.InferencePipeline

    class Capture(orig):
        def push_scan(self, scan, tf=None):
            out = super().push_scan(scan, tf)
            steps.append((out, len(scan)))
            return out

    cli_module.InferencePipeline = Capture
    try:
        yield steps
    finally:
        cli_module.InferencePipeline = orig


def to_numpy(tree):
    """A dict of torch tensors or jax arrays (nested) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def sample_index(n_raw: int, seq: int, step: int) -> np.ndarray:
    """The sampled points of one scan: a fixed seeded choice."""
    rng = np.random.default_rng(1000 * seq + step)
    return np.sort(rng.choice(n_raw, size=min(N_SAMPLE, n_raw),
                              replace=False)).astype(np.int32)


def summarize(steps, pred_root: str, seq: int) -> list[dict]:
    """Per step of one sequence: the captured outputs (``steps``, one
    sequence's) condensed, beside what the artifacts under ``pred_root``
    (``<out>/<experiment id>``) hold."""
    sub = os.path.join("sequences", f"{seq:02d}", "predictions")
    labels = load_files(os.path.join(pred_root, "mos_preb", sub))
    bboxes = load_files(os.path.join(pred_root, "bbox_preb", sub))
    if not (len(labels) == len(bboxes) == len(steps)):
        raise AssertionError(f"sequence {seq:02d}: {len(steps)} steps, "
                             f"{len(labels)} labels, {len(bboxes)} boxes")
    rows = []
    for t, ((out, n_raw), lab, box) in enumerate(zip(steps, labels, bboxes)):
        out = to_numpy({k: out[k] for k in ("point_logits", "overflow")})
        idx = sample_index(n_raw, seq, t)
        ids = np.fromfile(lab, dtype=np.int32)
        if len(ids) != n_raw:
            raise AssertionError(f"{lab}: {len(ids)} labels, {n_raw} points")
        pred = np.load(box, allow_pickle=True).item()
        ovf = out["overflow"]
        rows.append(dict(
            n_raw=np.int64(n_raw), idx=idx,
            logits=out["point_logits"][:n_raw][idx].astype(np.float32),
            counts=np.array([(ids == v).sum() for v in (0, 9, 251)],
                            np.int64),
            boxes=pred["pred_boxes"], scores=pred["pred_scores"],
            labels=pred["pred_labels"],
            motion_dropped=np.asarray(ovf["motion_dropped"], np.int64),
            span_overflow=np.asarray(ovf.get("span_overflow", []), np.int64),
            **{k: np.int64(ovf[k]) for k in COUNTERS}))
    return rows


def save_record(path: str, cfg: Config, record: dict[str, list[dict]],
                **meta) -> None:
    """``record``: sequence name -> :func:`summarize` rows."""
    flat = {"config": np.array(json.dumps(cfg.to_dict())),
            "meta": np.array(json.dumps(meta))}
    for name, rows in record.items():
        for t, row in enumerate(rows):
            for k, v in row.items():
                flat[f"{name}/{t}/{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_record(path: str):
    """(cfg, meta, record) as :func:`save_record` wrote them."""
    with np.load(path) as z:
        cfg = Config.from_dict(json.loads(str(z["config"])))
        meta = json.loads(str(z["meta"]))
        record: dict[str, dict[int, dict]] = {}
        for key in z.files:
            if key.count("/") != 2:
                continue
            name, t, k = key.split("/")
            record.setdefault(name, {}).setdefault(int(t), {})[k] = z[key]
    return cfg, meta, {n: [r[t] for t in sorted(r)] for n, r in record.items()}


def match_boxes(ref, got, tol: float):
    """(record boxes with no port box within ``tol``, the largest
    |difference| over those that have one), over the 7 box parameters and
    the score; labels must agree on the matched pairs."""
    rb = np.concatenate([ref["boxes"], ref["scores"][:, None]], 1)
    gb = np.concatenate([got["boxes"], got["scores"][:, None]], 1)
    if not len(rb) or not len(gb):
        return len(rb), 0.0
    d = np.abs(rb[:, None, :] - gb[None, :, :]).max(-1)
    near = d.argmin(1)
    hit = (d.min(1) <= tol) & (ref["labels"] == got["labels"][near])
    return int((~hit).sum()), float(d.min(1)[hit].max(initial=0.0))


def compare(record_rows: list[dict], rows: list[dict], W: int,
            route: str) -> dict:
    """One sequence of the port (``rows``) against the record. Every step
    whose span plans covered every row is compared (every full-window step
    must be: the overflow gates hold there). Returns the per-step readings
    and the failures; the caller fails the run on any failure."""
    tol = TOLERANCES[route]
    steps, failures = [], []
    if len(rows) != len(record_rows):
        failures.append(f"{len(rows)} steps, record {len(record_rows)}")
    for t, (r, g) in enumerate(zip(record_rows, rows)):
        covered = not int(np.abs(g["span_overflow"]).sum())
        if t >= W - 1 and not covered:
            failures.append(f"step {t}: span_overflow {g['span_overflow']}")
        if not covered:
            steps.append(dict(step=t, compared=False))
            continue
        e = np.abs(g["logits"] - r["logits"])
        n_md = len(r["motion_dropped"])
        s = dict(
            step=t, compared=True, max_abs=float(e.max()),
            share_over_1e_3=float((e > 1e-3).mean()),
            count_diff=(g["counts"] - r["counts"]).tolist(),
            boxes=len(r["boxes"]), boxes_got=len(g["boxes"]),
            counters_equal=bool(
                all(int(g[k]) == int(r[k]) for k in COUNTERS)
                and np.array_equal(g["motion_dropped"][:n_md],
                                   r["motion_dropped"])
                and not g["motion_dropped"][n_md:].any()))
        s["boxes_unmatched"], s["box_abs"] = match_boxes(r, g,
                                                         tol["box_abs"])
        steps.append(s)
        bad = []
        if not np.array_equal(g["idx"], r["idx"]) or g["n_raw"] != r["n_raw"]:
            bad.append("scan or sample differs")
        if s["max_abs"] > tol["logit_abs"]:
            bad.append(f"logits max abs {s['max_abs']:.3g}")
        if s["share_over_1e_3"] > tol["share_over_1e_3"]:
            bad.append(f"share over 1e-3 {s['share_over_1e_3']:.3g}")
        if max(abs(c) for c in s["count_diff"]) > tol["count_share"] * int(
                r["n_raw"]):
            bad.append(f"label counts {s['count_diff']}")
        if s["boxes"] != s["boxes_got"] or s["boxes_unmatched"] > tol[
                "box_unmatched_share"] * s["boxes"]:
            bad.append(f"kept boxes {s['boxes_got']} vs {s['boxes']}, "
                       f"{s['boxes_unmatched']} unmatched")
        if not s["counters_equal"]:
            bad.append("counters differ: " + str(
                {k: (int(g[k]), int(r[k])) for k in COUNTERS})
                + f" motion_dropped {g['motion_dropped'].tolist()} vs "
                f"{r['motion_dropped'].tolist()}")
        if bad:
            failures.append(f"step {t}: " + "; ".join(bad))
    compared = [s for s in steps if s["compared"]]
    return dict(
        route=route, steps=steps, failures=failures,
        compared=len(compared),
        max_abs=max((s["max_abs"] for s in compared), default=0.0),
        share_over_1e_3=max((s["share_over_1e_3"] for s in compared),
                            default=0.0),
        box_abs=max((s["box_abs"] for s in compared), default=0.0),
        boxes_unmatched=max((s["boxes_unmatched"] for s in compared),
                            default=0))
