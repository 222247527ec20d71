"""The span convs' share of their roofline: the least time the card could
take for their useful work over the device time of the activities
launched inside the program's ``insmos::span_conv`` op. The work is the
benchmark's own count (``portbench/work.py``): pairs from the sites'
coordinates, each conv bound by the larger of its FLOPs at 989 TFLOP/s
and its bytes (inputs read once, outputs written once) at 3.35 TB/s."""

LAYER = "sparse-conv op (sparse/span_conv.py, insmos::span_conv)"
UNIT = "%"
BETTER = "higher"
MOVES = "scans_per_s"


def read(rec):
    t = rec["trace"]["charged_s"].get("insmos::span_conv")
    if not rec["on_card"] or not t:
        return None
    return 100.0 * rec["work"]["span_bound_s"] / t
