"""Host time a scan of the program's ``tail`` span over the profiled steps
(``insmos_tpu_torch.obs`` step records), around
``InsMOSModel.forward_tail``: UNet with its span plans, BEV, head, decode
and NMS, instance fusion, MOS head, devoxelize."""

LAYER = "UNet / BEV / head / fusion (model.forward_tail)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"
SPAN = "tail"


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
