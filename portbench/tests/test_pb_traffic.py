"""The tiled world keeps the fixture's points a scan and sites a step
over a drive far longer than the fixture's world (which ends at x = +-70
m), every step of the ref-exact drive turns, the fixed-frame drive's steps
are integer-voxel translations, and a step's scan does not depend on the
steps made before it."""

import numpy as np

from portbench import traffic
from portbench.tests.pb_common import mix


def test_long_drive_keeps_the_fixture_density():
    st = traffic.Stream(2**31 + 12345, mix(), 131072, False, 0.1, 500)
    counts, sites = [], []
    for w in range(0, 500, 50):
        s = st.scan(w)
        counts.append(len(s))
        vox = np.unique(np.floor((s[:, :3] + [64.0, 54.4, 7.2]) * 10).astype(
            np.int64), axis=0)
        sites.append(len(vox))
    assert st.poses[-1, 0, 3] > 500.0  # ~4 tiles past the fixture's world
    assert min(counts) > 115_000 and max(counts) <= 131072, counts
    assert max(sites) < 1.3 * min(sites), sites


def test_turning_and_framing():
    world = mix()["world"]
    poses = traffic.drive_poses(7, 300, world)
    psi = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
    d = np.abs(np.diff(psi))
    assert d.max() <= world["turn_max_rad"] + 1e-12
    assert (d[:] > 0).all()
    assert np.abs(psi).max() <= world["heading_band_rad"] + 1e-12
    st = traffic.Stream(7, mix(), 131072, True, 0.1, 20)
    for w in range(4):
        scan, tf = st.next()
        k = tf[:3, 3] / 0.1
        assert np.allclose(tf[:3, :3], np.eye(3))
        assert np.allclose(k, np.round(k), atol=1e-3)


def test_scans_are_independent_of_order():
    a = traffic.Stream(3, mix(), 131072, False, 0.1, 10)
    b = traffic.Stream(3, mix(), 131072, False, 0.1, 10)
    first = [a.next() for _ in range(3)]
    np.testing.assert_array_equal(b.scan(2), first[2][0])
