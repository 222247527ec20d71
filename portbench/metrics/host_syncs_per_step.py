"""Operations that blocked the host until the card's stream drained, a
step, over the profiled steps: the program's ``host_syncs`` counter
(``insmos_tpu_torch.obs``), which counts them while tracing is on,
through ``torch.cuda.set_sync_debug_mode("warn")``: copies to the host,
uploads from pageable memory, ``nonzero`` and other data-dependent
shapes. Each one stops the host from queueing work ahead of the card."""

LAYER = "pipeline glue (pipeline.py, nn, sparse)"
UNIT = "syncs/step"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    if not rec["on_card"]:
        return None
    try:
        from insmos_tpu_torch import obs
    except ImportError:  # a program without the counter
        return None
    n = rec["scans"] // rec["streams"]
    steps = obs.records()[-n:] if n else []
    if len(steps) < n or not steps:
        return None
    return sum(r["counters"].get("host_syncs", 0) for r in steps) / n
