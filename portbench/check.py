"""The numbers that decide ``correct``: the program's outputs on sampled
steps against the plain reference's, each number beside its limit.

- ``logit_rel_rms``: the RMS of the per-point MOS logit gap over every
  point of every compared step, over the reference's RMS.
- ``logit_max_gap``: the widest per-point logit gap, reported and not
  compared: the float8 control reads it at 1.03-1.71 and the program at
  up to 0.87, no factor of three apart, so no limit would hold.
- ``box_miss_share``: the kept boxes clear of the score gate (score at
  least ``score_thresh + BOX_MARGIN``) on either side that find no kept
  box of the same label within ``BOX_DIST_M`` on the other side, as a
  share of all such boxes. A box near the gate may fall either side of
  it under rounding; one clear of it may not.
- On the matched pairs (each box clear of the gate with the nearest box
  of its label within ``BOX_DIST_M`` on the other side, from both
  sides), the median over all pairs of: ``box_score_p50``, the score
  gap; ``box_size_rel_p50``, the gap of each of the three sizes over the
  reference's size; ``box_z_rel_p50``, the gap of the centre's height
  over the reference box's height. A fault of the head's decode (sizes,
  scores, heights) moves every box and so the median. The RMS over the
  pairs (``*_rms``) is reported and not compared: in bfloat16 a few boxes
  whose nearest match is a near-tie neighbour set it, and the float8
  control reads it at less than three times the program's. The yaw is
  not compared: bfloat16 turns a kept box by up to 0.35 rad where its
  class map is nearly round.
"""

from __future__ import annotations

import numpy as np

BOX_MARGIN = 0.05
BOX_DIST_M = 1.0
NAMES = ("logit_rel_rms", "box_miss_share", "box_score_p50",
         "box_size_rel_p50", "box_z_rel_p50")


def _matches(a, b, gate):
    """(boxes of ``a`` clear of the gate, those unmatched in ``b``, the
    matched pairs as (index in a, index in b))."""
    sel = np.nonzero(a["scores"] >= gate)[0]
    miss, pairs = 0, []
    for ia in sel:
        same = np.nonzero(b["labels"] == a["labels"][ia])[0]
        if not len(same):
            miss += 1
            continue
        d = np.hypot(*(b["boxes"][same][:, :2] - a["boxes"][ia][None, :2]).T)
        j = int(np.argmin(d))
        if d[j] > BOX_DIST_M:
            miss += 1
        else:
            pairs.append((int(ia), int(same[j])))
    return len(sel), miss, pairs


def _rms(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sqrt((x * x).mean())) if x.size else 0.0


def _p50(x) -> float:
    x = np.abs(np.asarray(x, np.float64))
    return float(np.median(x)) if x.size else 0.0


def compare(pairs, score_thresh: float) -> dict:
    """pairs: [(program outputs, reference outputs)] of the compared
    steps, each a dict of point_logits (n, 3), boxes (k, 7), scores (k,),
    labels (k,). Returns each number of NAMES, and those reported beside
    them."""
    sq = ref_sq = 0.0
    max_gap = 0.0
    n_box = n_miss = 0
    score, size, zrel = [], [], []
    gate = score_thresh + BOX_MARGIN
    for got, ref in pairs:
        d = got["point_logits"].astype(np.float64) - ref["point_logits"]
        sq += float((d * d).sum())
        ref_sq += float((ref["point_logits"].astype(np.float64) ** 2).sum())
        if d.size:
            max_gap = max(max_gap, float(np.abs(d).max()))
        for a, b, flip in ((got, ref, False), (ref, got, True)):
            n, m, matched = _matches(a, b, gate)
            n_box += n
            n_miss += m
            for ia, ib in matched:
                ig, ir = (ib, ia) if flip else (ia, ib)
                bg = got["boxes"][ig].astype(np.float64)
                br = ref["boxes"][ir].astype(np.float64)
                score.append(float(got["scores"][ig]) - float(ref["scores"][ir]))
                size.extend(((bg[3:6] - br[3:6]) / br[3:6]).tolist())
                zrel.append((bg[2] - br[2]) / br[5])
    return dict(logit_rel_rms=float(np.sqrt(sq / max(ref_sq, 1e-30))),
                logit_max_gap=max_gap,
                box_miss_share=n_miss / n_box if n_box else 0.0,
                box_score_rms=_rms(score), box_score_p50=_p50(score),
                box_size_rel_rms=_rms(size), box_size_rel_p50=_p50(size),
                box_z_rel_rms=_rms(zrel), box_z_rel_p50=_p50(zrel),
                boxes_compared=n_box, box_pairs=len(score))


def verdict(numbers: dict, limits: dict, names) -> tuple[bool, dict]:
    """(every number of ``names`` within its limit, {name: {value,
    limit}})."""
    out = {n: {"value": numbers[n], "limit": limits[n]} for n in names}
    return all(numbers[n] <= limits[n] for n in names), out
