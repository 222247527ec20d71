"""tools.device_ms on the CPU, with torch.profiler's sessions made up: a
session that records fewer device activities than calls (CUPTI now and then
hands back none) is run again, and after the last try the time comes from
CUDA events."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from insmos_tpu_torch import tools

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(device_type, count, us):
    return SimpleNamespace(device_type=device_type, count=count,
                           self_device_time_total=us)


WHOLE = [_ev(CPU, 10, 0.0), _ev(CUDA, 10, 30.0), _ev(CUDA, 10, 10.0)]
# no device activity, fewer than one a call, no device time
SHORT = [[_ev(CPU, 10, 0.0)], [_ev(CUDA, 4, 12.0)], [_ev(CUDA, 10, 0.0)]]


@pytest.fixture
def sessions(monkeypatch):
    """Stands in for torch.profiler.profile: session k hands back the k-th
    list of made-up key_averages() entries; returns the list to fill and
    the count of sessions opened."""
    queue, opened = [], []

    class Prof:
        def __init__(self, activities):
            opened.append(activities)
            self.evs = queue.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.evs

    monkeypatch.setattr(tools, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(tools, "cuda_ms", lambda fn, reps: 7.0)
    monkeypatch.setattr(tools, "SESSIONS", {"whole": 0, "short": 0,
                                            "events": 0})
    return queue, opened


@pytest.mark.parametrize("before", [0, 1, 3])
def test_device_ms_runs_a_short_session_again(sessions, before):
    queue, opened = sessions
    queue += SHORT[:before] + [WHOLE]
    calls = []
    ms = tools.device_ms(lambda: calls.append(1), reps=10, tries=4)
    assert ms == pytest.approx(40.0 / 1e3 / 10)
    assert len(opened) == before + 1
    assert len(calls) == 1 + 10 * (before + 1)  # one warm-up call
    assert tools.SESSIONS == {"whole": 1, "short": before, "events": 0}


def test_device_ms_falls_back_to_events(sessions, capsys):
    queue, opened = sessions
    queue += SHORT
    assert tools.device_ms(lambda: None, reps=10, tries=3) == 7.0
    assert len(opened) == 3
    assert tools.SESSIONS == {"whole": 0, "short": 3, "events": 1}
    assert "CUDA events instead" in capsys.readouterr().err
