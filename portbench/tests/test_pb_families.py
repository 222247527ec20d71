"""A model family is a file. InsMOS's run through its family
(``portbench/families/insmos.py``) gives the result recorded before the
harness took its model from a family (``insmos_small.json``: the small
configuration on the CPU, both mixes, the pod at 2 slots, times left out).
A probe family written to a directory of its own, with a comparison of
its own, runs through the harness unchanged: its numbers are the ones
checked, its sound path is correct and a planted box fault is not.

    python -m portbench.tests.test_pb_families

(from the checkout's root) writes the record anew from the tree it runs
in."""

import json
import os

import pytest

from portbench.run import load_family, run
from portbench.tests.pb_common import ROOT, config_doc, mix, small_config

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "insmos_small.json")
SEEDS = {"drive": 2**31 + 77, "pod8": 3500000001}
# the fields of a result that time something
TIMED = {"window": ("feed_s", "feed_share", "step_ms_quartiles",
                    "halves_scans_per_s"),
         "compared": ("seconds", "window_s")}


def _limits():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "insmos-n10-refexact.json")) as fh:
        return json.load(fh)["check"]["limits"]


def _untimed(res) -> dict:
    res = json.loads(json.dumps(res))
    del res["metrics"]
    for part, keys in TIMED.items():
        for k in keys:
            del res[part][k]
    return res


def insmos_result(name: str) -> dict:
    """The untimed result of a one-step window of mix ``name`` (the pod at
    2 slots) at the small configuration on the CPU."""
    m = mix(name, streams=2) if name == "pod8" else mix(name)
    res, _ = run(config_doc(small_config(False), _limits()), m, SEEDS[name],
                 0.0, False, [], device="cpu")
    return _untimed(res)


def _same(got, want, path="result"):
    """Counts, flags and names equal; every float within 1e-6 of it."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=0), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", ["drive", "pod8"])
def test_insmos_result_unchanged(name):
    with open(RECORD) as fh:
        want = json.load(fh)[name]
    got = insmos_result(name)
    _same(got, want)
    assert got["compared"]["steps"] > 0


_PROBE = '''
"""A probe family: InsMOS's program and reference with a class head steep
enough that boxes clear the score gate at the tests' small size, compared
on its boxes alone; each box's centre raised by Z_SHIFT of its height
where the program's outputs reach the host."""

from portbench.run import load_family

_base = load_family("insmos")
CONTROL_DTYPE, INEXACT, CARRIED, RANGES = (
    _base.CONTROL_DTYPE, _base.INEXACT, _base.CARRIED, _base.RANGES)
window, reference, compare, step_work = (
    _base.window, _base.reference, _base.compare, _base.step_work)
NAMES = tuple(n for n in _base.NAMES if n != "logit_rel_rms")
Z_SHIFT = {z_shift!r}


def build(cd, device):
    model, sd = _base.build(cd, device)
    sd["head.cls.w"] *= 30.0
    sd["head.cls.b"][:] = -9.0
    model.load_state_dict(sd)
    return model, sd


class Server(_base.Server):
    def fetch(self, out, item):
        host = super().fetch(out, item)
        for h in host:
            h["boxes"][:, 2] += Z_SHIFT * h["boxes"][:, 5]
        return host
'''


@pytest.fixture(scope="module")
def probe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    for name, z in (("probe", 0.0), ("probe_z", 0.5)):
        (d / f"{name}.py").write_text(_PROBE.format(z_shift=z))
    return str(d)


@pytest.mark.parametrize("family,correct", [("probe", True),
                                            ("probe_z", False)])
def test_probe_family_runs_without_edits(probe_dir, family, correct):
    names = load_family(family, probe_dir).NAMES
    assert "logit_rel_rms" not in names
    doc = config_doc(small_config(False, score_thresh=0.1),
                     {n: _limits()[n] for n in names})
    doc["family"] = family
    res, lines = run(doc, mix(), 2**31 + 91, 0.0, False, [], device="cpu",
                     families_dir=probe_dir)
    assert list(res["check"]) == list(names)
    assert len(lines) == len(names)
    assert res["compared"]["steps"] > 0 and res["compared"]["boxes"] > 0
    assert res["correct"] is correct, res["check"]


if __name__ == "__main__":
    out = {name: insmos_result(name) for name in SEEDS}
    with open(RECORD, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
