"""The CenterPoint family: CenterPoint, voxel variant, on nuScenes
(``insmos_tpu_torch/nn/centerpoint.py``) as the port runs it, served by
``SweepPipeline`` over a ring of 10 sweeps.

Everything the harness (``portbench/run.py``) takes from the architecture:
the program's model on the benchmark's weights (``portbench/cp_weights.py``,
the block conv biases folded into their BN for the program), the
pipeline, the gates that make a scan inexact, the window and the scan
producer's arguments, the plain reference
(``portbench/reference/centerpoint.py``), the comparison that decides
``correct``, a step's useful work (``portbench/work.py``) and the host
ranges around the model's three parts.

The comparison holds the kept boxes alone, by ``portbench/check.py``'s
matching: the dense maps are not fetched on the timed path (the harness
keeps every step's outputs on the host), and the CPU tests hold them to
the reference instead.
"""

from __future__ import annotations

import numpy as np

from insmos_tpu_torch.centerpoint_config import CenterPointConfig
from insmos_tpu_torch.nn.centerpoint import CenterPointModel
from insmos_tpu_torch.nn.voxel_res_backbone import fold_block_bias
from insmos_tpu_torch.pipeline import SweepPipeline

from portbench import check, cp_weights, work
from portbench.reference import centerpoint as ref

# the control: the reference with float8 (e4m3) matmul operands, the
# precision below the configuration's bfloat16
CONTROL_DTYPE = "float8_e4m3fn"
NAMES = ("box_miss_share", "box_score_p50", "box_size_rel_p50",
         "box_z_rel_p50", "box_vel_p50")
# gates that make a scan inexact: voxels or sites dropped at a capacity,
# or a span plan that left a conv row uncovered
INEXACT = ("voxels_dropped", "span_overflow", "sites_dropped")
CARRIED = {}
# (model method, host range, idle-gap label)
RANGES = (("forward_backbone3d", "pb.backbone3d", "backbone3d"),
          ("forward_dense", "pb.dense", "dense"),
          ("forward_post", "pb.post", "post"))


def window(cd: dict):
    """(sweeps in the window, no carried state, the scan producer's (most
    points a sweep, not fixed-frame, voxel edge))."""
    return (cd["sweeps"]["n_sweeps"], False,
            (cd["runtime"]["max_points_per_scan"], False,
             cd["data"]["voxel_size"][0]))


def build(cd: dict, device):
    """(the program's model in eval mode, the benchmark's weights as a
    state dict on ``device`` in the reference's layout)."""
    sd = cp_weights.state_dict(cd, device)
    model = CenterPointModel(CenterPointConfig.from_dict(cd))
    model.load_state_dict(fold_block_bias(sd))
    model.eval()
    return model, sd


class Server:
    """``SweepPipeline`` for one stream."""

    recoveries = 0  # no recovery steps

    def __init__(self, cd: dict, model, mix: dict, device):
        if mix["entry"] != "SweepPipeline" or mix["streams"] != 1:
            raise ValueError("CenterPoint is served by SweepPipeline, one "
                             "stream")
        self.S = 1
        self.pipe = SweepPipeline(model.cfg, model, device)

    def push(self, item):
        scan, tf = item[0]
        return self.pipe.push_scan(scan, tf)

    def fetch(self, out, item) -> list:
        return [SweepPipeline.fetch(out, len(item[0][0]))]

    @staticmethod
    def gates(out) -> dict:
        return out["overflow"]


def reference(cd: dict, sd: dict, scans, tfs, *, device,
              dtype: str = "float32", tape=None) -> dict:
    """One step of the plain reference from the window's sweeps and
    transforms (oldest first, None before the stream began)."""
    return ref.step(cd, sd, scans, tfs, device=device, dtype=dtype,
                    tape=tape)


def compare(pairs, cd: dict) -> dict:
    """The check's numbers over [(program outputs, reference outputs)]:
    ``check.py``'s box numbers (yaw left out), and ``box_vel_p50``, the
    median over the matched pairs of the norm of the velocity gap (m/s,
    as the head gives it)."""
    gate = cd["model"]["post"]["score_thresh"] + check.BOX_MARGIN
    n_box = n_miss = 0
    score, size, zrel, vel = [], [], [], []
    for got, want in pairs:
        for a, b, flip in ((got, want, False), (want, got, True)):
            n, m, matched = check._matches(a, b, gate)
            n_box += n
            n_miss += m
            for ia, ib in matched:
                ig, ir = (ib, ia) if flip else (ia, ib)
                bg = got["boxes"][ig].astype(np.float64)
                br = want["boxes"][ir].astype(np.float64)
                score.append(float(got["scores"][ig])
                             - float(want["scores"][ir]))
                size.extend(((bg[3:6] - br[3:6]) / br[3:6]).tolist())
                zrel.append((bg[2] - br[2]) / br[5])
                vel.append(float(np.hypot(*(bg[7:9] - br[7:9]))))
    return dict(box_miss_share=n_miss / n_box if n_box else 0.0,
                box_score_p50=check._p50(score),
                box_size_rel_p50=check._p50(size),
                box_z_rel_p50=check._p50(zrel), box_vel_p50=check._p50(vel),
                box_score_rms=check._rms(score),
                box_size_rel_rms=check._rms(size),
                box_z_rel_rms=check._rms(zrel), box_vel_rms=check._rms(vel),
                boxes_compared=n_box, box_pairs=len(score))


def step_work(cd: dict, sd: dict, scans, tfs, device) -> dict:
    """One step of useful work by the benchmark's rulebook
    (:func:`portbench.work.step_work`), from the reference's tape: every
    sparse conv's pairs (all of them feed the dense BEV) and the dense
    convs by shape."""
    act_bytes = 2 if cd["runtime"]["compute_dtype"] != "float32" else 4
    tape = ref.Tape()
    r = reference(cd, sd, scans, tfs, device=device, tape=tape)
    return work.step_work(work.cone(tape), r["dense_flops"], act_bytes)
