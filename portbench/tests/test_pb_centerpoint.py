"""The CenterPoint family (``portbench/families/centerpoint.py``) through
the harness on the CPU, at a small configuration: the published widths on
a 19.2 m square, 2,048 points a sweep. Its sound path is correct under
the configuration file's limits; a probe family that plants a fault where
the program's boxes reach the host (each centre raised by half its
height, or the velocity's sign flipped) is not. The two new mixes load
and differ from ``drive`` only where they say, and the weights recipe is
deterministic. The cells, the configuration and the five ``cp_*``
readers agree with BENCHMARK.json, every per-layer reader agrees with
its entry, and the readers that read any architecture list the new cell.

    python -m pytest portbench/tests/test_pb_centerpoint.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from portbench import cp_weights
from portbench.run import load_family, load_metric, load_mix, run
from portbench.tests.pb_common import ROOT, mix

CONFIG = os.path.join(ROOT, "portbench", "configs",
                      "centerpoint-voxel0075-nus.json")
CELL = "cp0075-nus32-drive"


def _doc(small: bool = True) -> dict:
    with open(CONFIG) as fh:
        doc = json.load(fh)
    if small:
        import torch

        from insmos_tpu_torch.centerpoint_config import CenterPointConfig

        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 2) // 2)))
        base = CenterPointConfig.from_dict(doc["config"])
        cfg = dataclasses.replace(
            base,
            data=dataclasses.replace(
                base.data, point_cloud_range=(-9.6, -9.6, -5.0, 9.6, 9.6,
                                              3.0)),
            model=dataclasses.replace(base.model,
                                      backbone=dataclasses.replace(
                                          base.model.backbone,
                                          max_voxels=16384,
                                          site_capacities=(32768, 16384, 8192,
                                                           4096))),
            runtime=dataclasses.replace(base.runtime,
                                        max_points_per_scan=2048,
                                        compute_dtype="float32"))
        doc["config"] = json.loads(json.dumps(cfg.to_dict()))
    return doc


_PROBE = '''
"""A probe family: CenterPoint's program and reference with a heatmap
head steep enough that boxes clear the gate at the tests' small size;
where the program's boxes reach the host each centre is raised by
Z_SHIFT of its height and the velocity multiplied by VEL_SIGN."""

from portbench.run import load_family

_base = load_family("centerpoint")
CONTROL_DTYPE, INEXACT, CARRIED, RANGES, NAMES = (
    _base.CONTROL_DTYPE, _base.INEXACT, _base.CARRIED, _base.RANGES,
    _base.NAMES)
window, reference, compare, step_work = (
    _base.window, _base.reference, _base.compare, _base.step_work)
Z_SHIFT = {z_shift!r}
VEL_SIGN = {vel_sign!r}


def build(cd, device):
    from insmos_tpu_torch.nn.voxel_res_backbone import fold_block_bias

    from portbench import cp_weights

    model, sd = _base.build(cd, device)
    for q in cp_weights.hm_names(cd):
        sd[q + ".w"] *= 8.0
    model.load_state_dict(fold_block_bias(sd))
    return model, sd


class Server(_base.Server):
    def fetch(self, out, item):
        host = super().fetch(out, item)
        for h in host:
            h["boxes"][:, 2] += Z_SHIFT * h["boxes"][:, 5]
            h["boxes"][:, 7:9] *= VEL_SIGN
        return host
'''


@pytest.fixture(scope="module")
def probe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    for name, z, v in (("cp_sound", 0.0, 1.0), ("cp_z", 0.5, 1.0),
                       ("cp_vel", 0.0, -1.0)):
        (d / f"{name}.py").write_text(_PROBE.format(z_shift=z, vel_sign=v))
    return str(d)


@pytest.mark.parametrize("family,correct,failing", [
    ("cp_sound", True, None), ("cp_z", False, "box_z_rel_p50"),
    ("cp_vel", False, "box_vel_p50")])
def test_family_through_the_harness(probe_dir, family, correct, failing):
    doc = _doc()
    doc["family"] = family
    m = mix("nus32", warm_steps=10)
    res, lines = run(doc, m, 2**31 + 91, 0.0, False, [], device="cpu",
                     families_dir=probe_dir)
    names = load_family("centerpoint").NAMES
    assert list(res["check"]) == list(names)
    assert len(lines) == len(names)
    assert res["compared"]["steps"] > 0, res["compared"]
    assert res["compared"]["numbers"]["box_pairs"] > 0, res["compared"]
    assert res["inexact"] == 0, res["compared"]["failed_by"]
    assert res["correct"] is correct, res["check"]
    if failing:
        value, limit = res["check"][failing]
        assert value > limit


def test_mixes_load():
    drive = load_mix("drive")
    nus = load_mix("nus32")
    crowd = load_mix("crowd")
    assert nus["entry"] == "SweepPipeline" and nus["streams"] == 1
    assert nus["sensor"]["beams"] * nus["sensor"]["azimuth_steps"] == 34688
    assert nus["world"]["speed_m"] == 0.55
    for k in drive["world"]:
        if k not in ("speed_m", "turn_max_rad", "weave_period"):
            assert nus["world"][k] == drive["world"][k], k
    assert crowd["world"]["cars_per_tile"] == 40
    for k in drive:
        if k not in ("about", "world", "hooks_file"):
            assert crowd[k] == drive[k], k
    for k in drive["world"]:
        if k != "cars_per_tile":
            assert crowd["world"][k] == drive["world"][k], k


def test_weights_deterministic():
    cd = _doc(small=False)["config"]
    a = cp_weights.state_dict(cd)
    b = cp_weights.state_dict(cd)
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k].numpy(), b[k].numpy()), k
    with np.load(cp_weights.CALIBRATED_STATE) as z:
        stats = {k for k in z.files if not k.endswith(".gain")}
        gains = {k[:-len(".gain")] for k in z.files if k.endswith(".gain")}
    assert stats and all(k.endswith((".mean", ".var")) for k in stats)
    assert {k for k in a if k.endswith((".mean", ".var"))} == stats
    assert gains == {q for _, _, q, _ in cp_weights.reg_heads(cd)}


def test_benchmark_entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    cells = {w["name"]: w for w in b["workloads"]}
    assert cells[CELL]["config"] == "centerpoint-voxel0075-nus"
    assert cells["refexact-crowd"]["config"] == "insmos-n10-refexact"
    assert all(cells[c]["chips"] == 1 for c in (CELL, "refexact-crowd"))
    doc = _doc(small=False)
    fam = load_family(doc["family"])
    assert doc["reduced"] == []
    assert set(doc["check"]["limits"]) == set(fam.NAMES)
    cp = [m for m in b["per_layer"] if m["name"].startswith("cp_")]
    assert len(cp) == 5
    assert all(m["workloads"] == [CELL] for m in cp)
    # InsMOS's ranges, and the ``insmos::greedy_nms`` op, which
    # CenterPoint's one ``greedy_nms_slots`` call does not go through
    insmos_only = ("motion_", "tail_", "nms_device_ms")
    for m in b["per_layer"]:
        mod = load_metric(m["name"])
        assert (m["unit"], m["better"], m["layer"], m["moves"]) == (
            mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES), m["name"]
        assert set(m["workloads"]) <= set(cells), m["name"]
        if not m["name"].startswith("cp_"):
            assert "refexact-crowd" in m["workloads"]
            assert (CELL in m["workloads"]) != m["name"].startswith(
                insmos_only), m["name"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["scan_latency_p90_ms"]["workloads"]
