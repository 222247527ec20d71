"""Peak device memory the program allocated over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start).
Memory a slot takes bounds the slots a card can serve."""

LAYER = "device (H100)"
UNIT = "GiB"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    if not rec["on_card"] or rec["window_peak_bytes"] <= 0:
        return None
    return rec["window_peak_bytes"] / 2.0**30
