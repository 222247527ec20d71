"""Host time a scan of the program's ``motion`` span over the profiled steps
(``insmos_tpu_torch.obs`` step records), around
``InsMOSModel.forward_motion``: MotionNet-4D with its span plans and the
current scan's voxelizer, launches and host syncs included."""

LAYER = "MotionNet (nn/minkunet4d.py via model.forward_motion)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"
SPAN = "motion"


def read(rec):
    try:
        from insmos_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    n = rec["scans"] // rec["streams"]
    steps = obs.records()[-n:] if n else []
    if len(steps) < n or not any(SPAN in r["spans"] for r in steps):
        return None
    ns = sum(r["spans"][SPAN]["incl_ns"] for r in steps if SPAN in r["spans"])
    return 1e-6 * ns / rec["scans"]
