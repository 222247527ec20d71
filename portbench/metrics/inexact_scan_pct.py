"""Share of the window's scans that the program served inexact by its own
gates: a span plan that left a conv row uncovered, points or sites
dropped at a capacity, or a full-stem recovery step. Such scans are not
compared. A plan that covers every row costs work, so a change to the
plans shows here and in the rate."""

LAYER = "step gates (span plans, site capacities)"
UNIT = "%"
BETTER = "lower"
MOVES = "scans_per_s"


def read(rec):
    return 100.0 * rec["inexact_share"]
