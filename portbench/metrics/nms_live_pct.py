"""Share of the rows the NMS tests that hold a live candidate, over the
profiled steps: the program's ``nms.live`` over ``nms.rows`` counters
(``insmos_tpu_torch.obs``, ``ops/nms.py``). The NMS runs its distance
test over all K candidate rows of every slot; a low share is work spent on
empty rows."""

LAYER = "NMS (ops/nms.py, insmos::greedy_nms)"
UNIT = "%"
BETTER = "higher"
MOVES = "scans_per_s"


def read(rec):
    try:
        from insmos_tpu_torch import obs
    except ImportError:  # a program without the counters
        return None
    n = rec["scans"] // rec["streams"]
    steps = obs.records()[-n:] if n else []
    if len(steps) < n or not steps:
        return None
    rows = sum(r["counters"].get("nms.rows", 0) for r in steps)
    if rows <= 0:
        return None
    live = sum(r["counters"].get("nms.live", 0) for r in steps)
    return 100.0 * live / rows
