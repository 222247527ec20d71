"""Device time a scan of the activities launched inside the benchmark's
``pb.tail`` range, around the model instance's ``forward_tail`` (UNet,
BEV backbone, head, decode and NMS, instance fusion, MOS head,
devoxelize)."""

LAYER = "UNet / BEV / head / fusion (model.forward_tail)"
UNIT = "ms/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    v = rec["trace"]["charged_s"].get("pb.tail")
    if not rec["on_card"] or not v:
        return None
    return 1e3 * v / rec["scans"]
