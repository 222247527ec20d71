"""Device time a scan of the activities launched inside the benchmark's
``pb.backbone3d`` range, around CenterPoint's ``forward_backbone3d``
(sweep merge, voxelizer, the sparse backbone with its span plans and
convs, the dense BEV)."""

LAYER = "CenterPoint sparse backbone (forward_backbone3d)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    v = rec["trace"]["charged_s"].get("pb.backbone3d")
    if not rec["on_card"] or not v:
        return None
    return 1e3 * v / rec["scans"]
