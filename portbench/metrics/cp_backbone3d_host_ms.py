"""Host time a scan of the program's ``backbone3d`` span over the profiled
steps (``insmos_tpu_torch.obs`` step records), around
``CenterPointModel.forward_backbone3d``: sweep merge, voxelizer, site
sets, span plans (graph replays on the card) and the sparse convs."""

LAYER = "CenterPoint sparse backbone (forward_backbone3d)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"
SPAN = "backbone3d"


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
