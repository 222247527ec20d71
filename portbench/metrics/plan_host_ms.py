"""Host time a scan of the program's ``plan`` spans over the profiled steps
(``insmos_tpu_torch.obs`` step records), around the two public functions
that make span plans, ``make_span_plans`` and ``make_span_plan``
(``sparse/span_conv.py``), in MotionNet and in the UNet: the plans' eager
glue, launched from the host every step."""

LAYER = "span plans (sparse/span_conv.py)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"
SPAN = "plan"


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
