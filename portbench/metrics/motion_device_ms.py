"""Device time a scan of the activities launched inside the benchmark's
``pb.motion`` range, around the model instance's ``forward_motion``
(MotionNet-4D, ``nn/minkunet4d.py``, and the voxelizer of the current
scan)."""

LAYER = "MotionNet (nn/minkunet4d.py via model.forward_motion)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    v = rec["trace"]["charged_s"].get("pb.motion")
    if not rec["on_card"] or not v:
        return None
    return 1e3 * v / rec["scans"]
