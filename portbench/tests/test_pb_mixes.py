"""A new traffic mix is new files only: a mix written to a directory of
its own, with a 32-beam sensor in its parameters and a ``<mix>.py`` that
brings its own streams and window loop, runs through the harness
unchanged."""

import json
import os

import numpy as np

from portbench import traffic
from portbench.run import load_mix, run
from portbench.tests.pb_common import ROOT, config_doc, mix, small_config

_HOOKS = '''
import time

from portbench import traffic

MADE = []


class Near(traffic.Stream):
    """The mix's own streams: the points within 15 m, at most 4096."""

    def next(self):
        scan, tf = super().next()
        keep = (abs(scan[:, 0]) < 15.0) & (abs(scan[:, 1]) < 15.0)
        return scan[keep][:4096], tf


def make_stream(seed, mix, max_points, fixed_frame, voxel, n_steps):
    return Near(seed, mix, max_points, fixed_frame, voxel, n_steps)


def window(steps, get, seconds):
    """An open loop: a scan arrives every period_s; its latency runs from
    its arrival to its outputs on the host. Exactly n_window steps."""
    lat, ends, feed = [], [], 0.0
    t0 = time.perf_counter()
    for k in range(3):
        arrival = t0 + 0.05 * k
        while time.perf_counter() < arrival:
            time.sleep(0.001)
        tg = time.perf_counter()
        item = get()
        feed += time.perf_counter() - tg
        steps.step(item)
        te = time.perf_counter()
        lat.extend([te - max(arrival, tg)] * steps.S)
        ends.append(te - t0)
    return dict(latency_s=lat, ends_s=ends, window_s=te - t0, feed_s=feed)
'''


def _write_mix(d):
    with open(os.path.join(ROOT, "portbench", "mixes", "drive.json")) as fh:
        m = json.load(fh)
    m["about"] = "a 32-beam sensor, its own streams and an open loop"
    m["sensor"] = dict(beams=32, elev_hi_deg=10.67, elev_lo_deg=-30.67,
                       azimuth_steps=1800, height_m=1.73, max_range_m=70.0)
    with open(os.path.join(d, "beam32.json"), "w") as fh:
        json.dump(m, fh)
    with open(os.path.join(d, "beam32.py"), "w") as fh:
        fh.write(_HOOKS)


def test_sensor_comes_from_the_mix(tmp_path):
    _write_mix(str(tmp_path))
    m32 = load_mix("beam32", str(tmp_path))
    a = traffic.Stream(9, mix(), 131072, False, 0.1, 4).scan(1)
    b = traffic.Stream(9, m32, 131072, False, 0.1, 4).scan(1)
    assert len(a) > 115_000
    assert len(b) <= 32 * 1800 < len(a) // 2
    assert np.abs(b[:, :2]).max() < 70.0 + 1.0


def test_new_mix_runs_without_edits(tmp_path):
    _write_mix(str(tmp_path))
    m = mix("beam32", str(tmp_path))
    assert m["hooks_file"] == str(tmp_path / "beam32.py")
    res, lines = run(config_doc(small_config(False), _limits()), m,
                     2**31 + 91, 0.1, False, [], device="cpu")
    assert res["window"]["steps"] == 3  # the mix's own loop
    assert res["compared"]["steps"] > 0
    assert res["correct"] is True, res["check"]


def _limits():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "insmos-n10-refexact.json")) as fh:
        return json.load(fh)["check"]["limits"]
