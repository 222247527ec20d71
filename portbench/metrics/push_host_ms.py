"""Host time a scan of the program's ``push`` spans over the profiled steps
(``insmos_tpu_torch.obs`` step records): the host work before the model,
in ``pipeline.py``: padding the scan, checking its transform, the uploads
and the window's roll (and in the pod, filling the slots' host arrays).
Inclusive time, so syncs and launches inside count."""

LAYER = "Pipeline (entry)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"
SPAN = "push"


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
