"""The train-step parity record (tests/torch_train_record.py and
insmos_tpu_torch/tools/train_record.py): the record script's JAX step and
the port's step summarize to within the record's tolerances at a tiny size
on the CPU; the comparer flags each kind of difference; the committed
record is the one the chip run expects."""

import copy
import os

import numpy as np
import pytest

from insmos_tpu_torch.tools import train_record as TR
from insmos_tpu_torch.tools.train_record import record_params

import torch_train_record
from test_torch_model import port_config
from torch_port_common import hdl64_crop_stream, tiny_config
from torch_train_common import train_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    cfg = port_config(tiny_config(window=3, points=1024))
    params, state = record_params(cfg)
    scans, _, _ = hdl64_crop_stream(3, seed=0, max_points=1024)
    sample = train_window(cfg, scans, seed=0)
    ref = torch_train_record.jax_summary(cfg, params, state, sample)
    got = TR.port_summary(cfg, params, state, sample, "cpu")
    return cfg, ref, got


def test_port_step_matches_the_jax_summary(tiny):
    cfg, ref, got = tiny
    fails, read = TR.compare(ref, got, cfg.train.lr, TR.TOLERANCES["jax"])
    assert not fails, (fails, read)
    # on this window the two packages' gradients agree far closer than
    # the record's bound for the reference's own error
    assert read["grad_rel"] <= 1e-4 and read["loss_rel"] <= 1e-5
    assert read["kept"][0] > 0 and read["confusion_equal"]
    n_leaves = sum(k.startswith("grad_norm/") for k in ref)
    assert n_leaves > 200 and sum(k.startswith("state/") for k in ref) > 100


@pytest.mark.parametrize("what", ["loss", "grad", "grad_norm", "param",
                                  "state", "boxes", "confusion", "keys"])
def test_compare_flags_each_difference(tiny, what):
    cfg, ref, _ = tiny
    got = copy.deepcopy(ref)
    key = next(k for k in got if k.startswith(what + "/")) if what not in (
        "boxes", "confusion", "keys") else what
    if what == "keys":
        got.pop(next(iter(got)))
    elif what == "boxes":
        got["boxes"] = got["boxes"].copy()
        got["boxes"][0, 0] += 0.5
    elif what == "confusion":
        got["confusion"] = got["confusion"].copy()
        got["confusion"][1, 1] += 1
    else:
        got[key] = np.asarray(got[key] * np.float32(1.5) + np.float32(0.5))
    for tol in TR.TOLERANCES.values():
        assert TR.compare(ref, ref, cfg.train.lr, tol)[0] == []
        assert TR.compare(ref, got, cfg.train.lr, tol)[0]


def test_committed_record():
    """The committed record is the cut of record_config in float32, fits
    in 1 MB, states its tolerances, holds finite values, was made from the
    window and weights that record_sample and record_params make, and its
    port CPU summary is within the JAX tolerances of its JAX summary."""
    path = os.path.join(REPO, TR.RECORD)
    assert os.path.getsize(path) <= 2**20
    cfg, meta, recs = TR.load_record(path)
    assert cfg == TR.record_config()
    assert meta["tolerances"] == TR.TOLERANCES
    sample = TR.record_sample(cfg)
    params, _ = TR.record_params(cfg)
    assert meta["inputs"] == pytest.approx(TR.fingerprint(sample, params),
                                           rel=1e-12)
    assert set(recs) == {"jax", "port_cpu"}
    for rec in recs.values():
        assert all(np.isfinite(v).all() for v in rec.values())
        assert len(rec["boxes"]) > 0 and rec["confusion"].sum() == \
            sample["num_points"][-1]
        assert all(f"loss/{k}" in rec for k in TR.LOSSES)
    assert not TR.compare(recs["jax"], recs["port_cpu"], cfg.train.lr,
                          TR.TOLERANCES["jax"])[0]
