"""Share of the span plans built in the profiled steps that replayed a
CUDA graph: the program's ``plan.replays`` over ``plan.builds`` counters
(``insmos_tpu_torch.obs``), counted in ``make_span_plans`` and
``make_span_plan`` (``sparse/span_conv.py``). A replayed plan is launched
from the host as one graph instead of its hundreds of small kernels one by
one; the pod's vmapped plans are built eagerly and read 0."""

LAYER = "span plans (sparse/span_conv.py)"
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
    builds = sum(r["counters"].get("plan.builds", 0) for r in steps)
    if builds <= 0:  # a program that does not count its plans
        return None
    replays = sum(r["counters"].get("plan.replays", 0) for r in steps)
    return 100.0 * replays / builds
