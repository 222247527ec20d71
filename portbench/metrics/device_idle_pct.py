"""Share of the profiled steps' wall time in which no kernel, copy or
memset ran on the card: one minus the union of the device activities'
intervals over the traced window (one trace, not sums of two windows).
Profiling adds host time to a step, so this reads somewhat above an
unprofiled step's idle share."""

LAYER = "device (H100)"
UNIT = "%"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    t = rec["trace"]
    if not rec["on_card"] or t["activities"] == 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
