"""Device time a scan of the activities launched inside the benchmark's
``pb.dense`` range, around CenterPoint's ``forward_dense`` (the BEV
backbone, the shared conv and the six groups' heads)."""

LAYER = "CenterPoint BEV backbone and heads (forward_dense)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    v = rec["trace"]["charged_s"].get("pb.dense")
    if not rec["on_card"] or not v:
        return None
    return 1e3 * v / rec["scans"]
