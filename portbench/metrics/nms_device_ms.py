"""Device time a scan of the activities launched inside the program's
``insmos::greedy_nms`` op (``ops/nms.py``), whichever kernels implement
it."""

LAYER = "NMS (ops/nms.py, insmos::greedy_nms)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    v = rec["trace"]["charged_s"].get("insmos::greedy_nms")
    if not rec["on_card"] or not v:
        return None
    return 1e3 * v / rec["scans"]
