"""The port's native host loader (insmos_tpu_torch/native): the cases of
tests/test_native.py, each held exactly against the JAX package's native
loader and against the port's numpy route (the loader's plain version)."""

import numpy as np
import pytest

from insmos_tpu import native as jax_native
from insmos_tpu_torch import native


def _write_scan(path, n, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-50, 50, size=(n, 4)).astype(np.float32)
    pts.tofile(path)
    return pts


def _tf(rng, yaw=True):
    tf = np.eye(4, dtype=np.float32)
    if yaw:
        a = rng.uniform(-np.pi, np.pi)
        tf[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    tf[:3, 3] = rng.uniform(-5, 5, 3)
    return tf


def _eq3(got, ref, plain):
    for a, b in ((got, ref), (got, plain)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_native_builds():
    assert native.build().exists()
    assert jax_native.available()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.mark.parametrize("yaw", [False, True], ids=["translation", "rigid"])
def test_load_scan_transformed(tmp_path, yaw):
    path = str(tmp_path / "s.bin")
    pts = _write_scan(path, 1000)
    tf = _tf(np.random.default_rng(2), yaw)
    got = native.load_scan_transformed(path, tf, 2048)
    _eq3(got, jax_native.load_scan_transformed(path, tf, 2048),
         native.load_scan_transformed_plain(path, tf, 2048))
    buf, n = got
    assert n == 1000 and (buf[n:] == 0).all()
    np.testing.assert_array_equal(buf[:n, 3], pts[:, 3])


def test_load_scan_truncation(tmp_path):
    path = str(tmp_path / "big.bin")
    _write_scan(path, 500)
    tf = np.eye(4, dtype=np.float32)
    got = native.load_scan_transformed(path, tf, 100)
    _eq3(got, jax_native.load_scan_transformed(path, tf, 100),
         native.load_scan_transformed_plain(path, tf, 100))
    assert got[1] == 100


def test_load_window_parallel(tmp_path):
    rng = np.random.default_rng(1)
    paths, tfs = [], []
    for i in range(6):
        p = str(tmp_path / f"{i}.bin")
        _write_scan(p, 300 + 17 * i, seed=i)
        paths.append(p)
        tfs.append(_tf(rng))
    tfs = np.stack(tfs)
    got = native.load_window(paths, tfs, 512)
    _eq3(got, jax_native.load_window(paths, tfs, 512),
         native.load_window_plain(paths, tfs, 512))
    np.testing.assert_array_equal(got[1], 300 + 17 * np.arange(6))


def test_unreadable_scan_raises(tmp_path):
    """No numpy fallback: a scan the loader cannot read raises."""
    with pytest.raises(OSError, match="missing"):
        native.load_window([str(tmp_path / "missing.bin")],
                           np.eye(4, dtype=np.float32)[None], 16)
