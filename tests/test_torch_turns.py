"""The turns runner's table (insmos_tpu_torch/tools/turns.py) on made-up
readings, on the CPU: one line per label in the order first read, each
run's events, device and one-call device ms, '-' where a run lacks the
reading (a path only the newer tree has, a probe without a one-call)."""

import importlib.util

import pytest

from insmos_tpu_torch.tools import probe_extract as PE
from insmos_tpu_torch.tools import probe_pallas_rowconv as RC
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


@pytest.mark.parametrize("probe", ["dot", "gather", "extract", "rowconv"])
def test_workers_exist(probe):
    assert turns.WORKERS[probe].is_file()


def test_table_without_a_one_call():
    rows = [_row("mma | 1", 0.5, 0.42)]
    line = turns.table([_run("old", rows), _run("new", rows)])[1]
    assert line == "mma | 1 | 0.5000, 0.5000 | 0.4200, 0.4200 | -, -"


def _worker(probe):
    spec = importlib.util.spec_from_file_location(f"w_{probe}",
                                                  turns.WORKERS[probe])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.worker


def _extract_main(scale, one_call=True):
    """probe_extract.main's result shape: two cases, three variants."""
    def main():
        out = []
        for i, name in enumerate(("L2", "L8")):
            r = dict(name=name, variants={
                v: dict(ms=scale * (i + 1 + j), device_ms=scale * (i + j),
                        err=1e-4) for j, v in enumerate("ABC")})
            if one_call:
                r.update(library_ms=0.5, library_device_ms=0.25 * (i + 1))
            out.append(r)
        return out
    return main


def _rowconv_main(scale):
    return lambda: [dict(name="rowconv small", ms=scale, device_ms=scale / 2,
                         max_abs_err=1e-6),
                    dict(name="rowconv L1-4D", ms=4 * scale,
                         device_ms=3 * scale, max_abs_err=2e-6)]


@pytest.mark.parametrize("probe", ["extract", "rowconv"])
def test_worker_rows_align_old_against_new(probe, monkeypatch):
    """The extract and rowconv workers on made-up probe results: one row per
    case (and variant), one per sum, and ``table`` aligns an old tree
    without the one-call reading against a new tree with it."""
    worker = _worker(probe)
    if probe == "extract":
        monkeypatch.setattr(PE, "main", _extract_main(1.0, one_call=False))
        old = worker(None)
        monkeypatch.setattr(PE, "main", _extract_main(0.1))
        new = worker(None)
        assert [r["label"] for r in new] == [
            "L2 | A", "L2 | B", "L2 | C", "L8 | A", "L8 | B", "L8 | C",
            "sum of 2 cases | A", "sum of 2 cases | B", "sum of 2 cases | C"]
        assert new[-1]["device_ms"] == pytest.approx(0.2 + 0.3)
        assert new[-1]["library_device_ms"] == pytest.approx(0.75)
        lines = turns.table([_run("old", old), _run("new", new),
                             _run("new", new), _run("old", old)])
        assert lines[1] == ("L2 | A | 1.0000, 0.1000, 0.1000, 1.0000 | "
                            "0.0000, 0.0000, 0.0000, 0.0000 | -, 0.2500, "
                            "0.2500, -")
        assert lines[-1].startswith("sum of 2 cases | C | 7.0000, 0.7000")
    else:
        monkeypatch.setattr(RC, "main", _rowconv_main(4.0))
        old = worker(None)
        monkeypatch.setattr(RC, "main", _rowconv_main(0.4))
        new = worker(None)
        assert [r["label"] for r in new] == [
            "rowconv small", "rowconv L1-4D", "sum of 2 cases"]
        lines = turns.table([_run("old", old), _run("new", new)])
        assert lines[3] == ("sum of 2 cases | 20.0000, 2.0000 | 14.0000, "
                            "1.4000 | -, -")
    assert len(lines) == len(new) + 1
