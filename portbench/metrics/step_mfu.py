"""The whole step's share of the card's bf16 peak: the step's useful
FLOPs (every sparse conv by the benchmark's rulebook, the dense BEV and
head convs from their shapes; ``portbench/work.py``) over the traced
run's own unprofiled step time x 989 TFLOP/s."""

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
MOVES = "scans_per_s"


def read(rec):
    w = rec["work"]
    if not rec["on_card"] or w["flops_per_step"] <= 0:
        return None
    return 100.0 * w["flops_per_step"] / (rec["window_step_s"]
                                          * w["peak_flops"])
