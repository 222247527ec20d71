"""The InsMOS family: InsMOS N_10_t_0.1_odom as the port runs it, in
either streaming mode (``runtime.incremental_stem``), served by
``InferencePipeline`` or ``PodInferencePipeline``.

Everything the harness (``portbench/run.py``) takes from the architecture:
the program's model on the benchmark's weights (``portbench/weights.py``),
the pipeline a mix names in ``entry``, the gates that make a scan inexact,
the window and the scan producer's arguments, the plain reference
(``portbench/reference/model.py``), the comparison that decides
``correct`` (``portbench/check.py``), a step's useful work
(``portbench/work.py``) and the host ranges around the model's two halves.
"""

from __future__ import annotations

from insmos_tpu_torch.config import Config
from insmos_tpu_torch.nn.model import InsMOSModel
from insmos_tpu_torch.pipeline import InferencePipeline, PodInferencePipeline

from portbench import check, weights, work
from portbench.reference import model as ref

# the control: the reference with float8 (e4m3) matmul operands, the
# precision below the configurations' bfloat16
CONTROL_DTYPE = "float8_e4m3fn"
NAMES = check.NAMES
# gates that make a scan inexact: the program dropped points or sites, or
# a span plan left a conv row uncovered
INEXACT = ("span_overflow", "motion_dropped", "unet_dropped",
           "voxelizer_capacity_dropped")
# what the fixed-frame mode carries into the later steps of a window: the
# new scan's stem plan (the first span plan) and its slab and the
# maintained window sites (the first two drop counters)
CARRIED = {"span_overflow": 1, "motion_dropped": 2}
# (model method, host range, idle-gap label): the ranges the traced run
# wraps around the model instance's two halves
RANGES = (("forward_motion", "pb.motion", "motion"),
          ("forward_tail", "pb.tail", "tail"))


def window(cd: dict):
    """(steps in the window, whether a step's inexactness carries into the
    later steps of its window, the scan producer's (most points a scan,
    fixed frame, voxel edge))."""
    fixed = bool(cd["runtime"]["incremental_stem"])
    return (cd["model"]["n_past_steps"], fixed,
            (cd["runtime"]["max_points_per_scan"], fixed,
             cd["data"]["voxel_size"][0]))


def build(cd: dict, device):
    """(the program's model in eval mode, the benchmark's weights as a
    state dict on ``device``)."""
    sd = weights.state_dict(cd, device)
    model = InsMOSModel(Config.from_dict(cd))
    model.load_state_dict(sd)
    model.eval()
    return model, sd


class Server:
    """The program's pipeline for one mix: ``InferencePipeline`` for one
    stream, ``PodInferencePipeline`` for a pod of ``mix["streams"]``."""

    def __init__(self, cd: dict, model, mix: dict, device):
        cfg = model.cfg
        self.S = mix["streams"]
        self.pod = mix["entry"] == "PodInferencePipeline"
        if mix["entry"] == "InferencePipeline":
            if self.S != 1:
                raise ValueError("InferencePipeline serves one stream")
            self.pipe = InferencePipeline(cfg, model, device)
        elif self.pod:
            self.pipe = PodInferencePipeline(cfg, model, [device], self.S)
        else:
            raise ValueError(f"unknown entry {mix['entry']!r}")

    @property
    def recoveries(self) -> int:
        """Full-stem recovery steps taken so far (fixed-frame mode): each
        is inexact on every stream."""
        return getattr(self.pipe, "n_full_steps", 0)

    def push(self, item):
        """Pushes one step's [(scan, tf)], one a stream; the device
        outputs."""
        if not self.pod:
            scan, tf = item[0]
            return self.pipe.push_scan(scan, tf)
        return self.pipe.push_scans([s for s, _ in item],
                                    [t for _, t in item])

    def fetch(self, out, item) -> list:
        """Every stream's outputs on the host."""
        if not self.pod:
            return [InferencePipeline.fetch(out, len(item[0][0]))]
        return [PodInferencePipeline.fetch(out, i, len(item[i][0]))
                for i in range(self.S)]

    @staticmethod
    def gates(out) -> dict:
        """The step's gate counters (device tensors, one row a stream)."""
        return out["overflow"]


def reference(cd: dict, sd: dict, scans, tfs, *, device,
              dtype: str = "float32", tape=None) -> dict:
    """One step of the plain reference from the window's scans and
    transforms (oldest first, None before the stream began)."""
    return ref.step(cd, sd, scans, tfs,
                    fixed_frame=bool(cd["runtime"]["incremental_stem"]),
                    device=device, dtype=dtype, tape=tape)


def compare(pairs, cd: dict) -> dict:
    """The check's numbers over [(program outputs, reference outputs)]."""
    return check.compare(pairs, cd["model"]["post"]["score_thresh"])


def step_work(cd: dict, sd: dict, scans, tfs, device) -> dict:
    """One stream's step of useful work by the benchmark's rulebook
    (:func:`portbench.work.step_work`), from the reference's tape."""
    act_bytes = 2 if cd["runtime"]["compute_dtype"] != "float32" else 4
    tape = ref.Tape()
    r = reference(cd, sd, scans, tfs, device=device, tape=tape)
    return work.step_work(work.cone(tape), r["dense_flops"], act_bytes)
