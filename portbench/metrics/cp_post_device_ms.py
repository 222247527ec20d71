"""Device time a scan of the activities launched inside the benchmark's
``pb.post`` range, around CenterPoint's ``forward_post`` (top-K decode of
six groups and their NMS, one slot a group)."""

LAYER = "CenterPoint decode and NMS (forward_post)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    v = rec["trace"]["charged_s"].get("pb.post")
    if not rec["on_card"] or not v:
        return None
    return 1e3 * v / rec["scans"]
