"""chip_smoke.py's report of the micro phase, built from made-up readings on
the CPU: one ``kernels`` entry per TPU kernel, with the events' and the
device's times summed over the probe's cases, and no one-call time where a
probe has none."""

import pytest

import chip_smoke


def _reading(tag, kernel, ms, device_ms, library_ms, library_device_ms,
             launches=1, err=0.0, bound_ms=0.01, bound_by="bytes"):
    return dict(tag=tag, kernel=kernel,
                source=f"insmos_tpu_torch/csrc/{kernel}",
                ms=ms, device_ms=device_ms, plain_ms=10 * ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                launches=launches, max_abs_err=err, bound_ms=bound_ms,
                bound_by=bound_by)


REPLACES = {"T8": "tools/micro_lanegather2.py:28",
            "T9": "tools/probe_tala.py:15",
            "T11": "tools/probe_pallas_rowconv.py:155"}


def _readings():
    return [
        _reading("T8", "lane_gather", 0.03, 0.004, 0.014, 0.003),
        _reading("T11", "rowconv", 5.0, 4.5, None, None, err=2e-6,
                 bound_ms=0.2, bound_by="operations"),
        _reading("T8", "lane_gather", 0.05, 0.006, 0.016, 0.005,
                 launches=2, bound_ms=0.02),
        _reading("T9", "lane_gather", 0.02, 0.002, 0.012, 0.0015),
        _reading("T11", "rowconv", 1.0, 0.5, None, None, err=1e-6,
                 bound_ms=0.01, bound_by="bytes"),
    ]


def test_micro_entries_sum_per_tpu_kernel():
    entries = chip_smoke.micro_entries(_readings(), REPLACES)
    assert [e["name"] for e in entries] == ["T8 lane_gather", "T9 lane_gather",
                                           "T11 rowconv"]
    t8, t9, t11 = entries
    assert t8["replaces"] == REPLACES["T8"] and t8["route"] == "cuda"
    assert t8["launches"] == 3
    assert t8["ms"] == pytest.approx(0.08)
    assert t8["device_ms"] == pytest.approx(0.010)
    assert t8["plain_ms"] == pytest.approx(0.8)
    assert t8["library_ms"] == pytest.approx(0.030)
    assert t8["library_device_ms"] == pytest.approx(0.008)
    assert t8["bound_ms"] == pytest.approx(0.03) and t8["bound_by"] == "bytes"
    assert t9["device_ms"] == pytest.approx(0.002)
    assert t9["library_device_ms"] == pytest.approx(0.0015)
    # the bound of T11 is mostly set by operations (0.2 of 0.21 ms)
    assert t11["bound_ms"] == pytest.approx(0.21)
    assert t11["bound_by"] == "operations"
    assert t11["max_abs_err"] == 2e-6


def test_micro_entries_pass_none_through():
    t11 = chip_smoke.micro_entries(_readings(), REPLACES)[2]
    assert t11["library_ms"] is None and t11["library_device_ms"] is None
    assert t11["device_ms"] == pytest.approx(5.0)
    assert t11["launches"] == 2


@pytest.mark.parametrize("key", ["library_ms", "library_device_ms"])
def test_micro_entries_none_if_any_case_lacks_a_one_call(key):
    rs = _readings()
    rs[2][key] = None  # one T8 case without a one-call
    t8 = chip_smoke.micro_entries(rs, REPLACES)[0]
    assert t8[key] is None
    other = ({"library_ms", "library_device_ms"} - {key}).pop()
    assert t8[other] is not None
