"""Host time a scan of the program's ``nms`` span over the profiled steps
(``insmos_tpu_torch.obs`` step records), around ``greedy_nms_slots``
(``ops/nms.py``): the device half's launches, its blocking copy to the
host, the greedy scan on the host and the keepers' upload."""

LAYER = "NMS (ops/nms.py, insmos::greedy_nms)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"
SPAN = "nms"


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
