"""The turns runner's table (insmos_tpu_torch/tools/turns.py) on made-up
readings, on the CPU: one line per label in the order first read, each
run's events, device and one-call device ms, '-' where a run lacks the
reading (a path only the newer tree has, a probe without a one-call)."""

import pytest

from insmos_tpu_torch.tools import turns


def _run(which, rows):
    return dict(which=which, card="card", tree=which, rows=rows)


def _row(label, ms, device_ms, library_device_ms=None):
    r = dict(label=label, ms=ms, device_ms=device_ms)
    if library_device_ms is not None:
        r["library_device_ms"] = library_device_ms
    return r


def test_table_aligns_runs_by_label():
    old = [_row("T1", 0.05, 0.034, 0.035), _row("T5", 0.04, 0.0102, 0.0106)]
    new = [_row("T1", 0.04, 0.025, 0.035), _row("T5", 0.03, 0.007, 0.0106),
           _row("T5 path=column", 0.03, 0.006, 0.0106)]
    lines = turns.table([_run("old", old), _run("new", new),
                         _run("new", new), _run("old", old)])
    assert lines[0] == ("label | events ms old, new, new, old | device ms "
                        "old, new, new, old | one-call device ms old, new, "
                        "new, old")
    assert lines[1] == ("T1 | 0.0500, 0.0400, 0.0400, 0.0500 | 0.0340, "
                        "0.0250, 0.0250, 0.0340 | 0.0350, 0.0350, 0.0350, "
                        "0.0350")
    assert lines[3] == ("T5 path=column | -, 0.0300, 0.0300, - | -, 0.0060, "
                        "0.0060, - | -, 0.0106, 0.0106, -")
    assert len(lines) == 4


@pytest.mark.parametrize("probe", ["dot", "gather"])
def test_workers_exist(probe):
    assert turns.WORKERS[probe].is_file()


def test_table_without_a_one_call():
    rows = [_row("mma | 1", 0.5, 0.42)]
    line = turns.table([_run("old", rows), _run("new", rows)])[1]
    assert line == "mma | 1 | 0.5000, 0.5000 | 0.4200, 0.4200 | -, -"
