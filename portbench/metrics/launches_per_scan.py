"""Device activities (kernels, copies, memsets) in the traced steps over
the scans they served: the launch overhead the eager glue of
``pipeline.py``, ``nn/*`` and ``sparse/*`` puts on the host."""

LAYER = "pipeline glue (pipeline.py, nn, sparse)"
UNIT = "launches/scan"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    t = rec["trace"]
    if not rec["on_card"] or t["activities"] == 0:
        return None
    return t["activities"] / rec["scans"]
