"""ctypes binding of the native host loader (loader.cpp; the port of
insmos_tpu/native).

The library is built with g++ at first use into
``insmos_tpu_torch/_build/native-<source hash>/`` and loaded with ctypes;
nothing is built at import time. A failed build, or a scan the loader
cannot read, raises: there is no silent fallback. The numpy route
(:func:`load_scan_transformed_plain`, :func:`load_window_plain`) is the
plain version beside it: the same arrays, bit for bit, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_lock = threading.Lock()
_LOADED: dict = {}
_F32P = ctypes.POINTER(ctypes.c_float)


def build() -> Path:
    """Compile loader.cpp unless this source and these flags were built
    already. Returns the library's path; raises if g++ fails."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib = out_dir / "libinsmos_loader.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libinsmos_loader.{os.getpid()}.so"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC),
                           "-lpthread"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    with _lock:
        if "lib" not in _LOADED:
            lib = ctypes.CDLL(str(build()))
            lib.load_scan_transformed.restype = ctypes.c_int
            lib.load_scan_transformed.argtypes = [
                ctypes.c_char_p, _F32P, _F32P, ctypes.c_int]
            lib.load_window.restype = None
            lib.load_window.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F32P, _F32P,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            _LOADED["lib"] = lib
        return _LOADED["lib"]


def _tfs(tfs, n: int) -> np.ndarray:
    return np.ascontiguousarray(tfs, dtype=np.float32).reshape(n, 16)


def load_scan_transformed(path: str, tf: np.ndarray, cap: int):
    """Read one KITTI .bin scan, keep its first ``cap`` points and apply
    the 4x4 ``tf`` to their xyz, into a zero-padded (cap, 4) buffer.
    Returns (buffer, count)."""
    out, counts = load_window([path], np.asarray(tf)[None], cap)
    return out[0], int(counts[0])


def load_window(paths: list[str], tfs: np.ndarray, cap: int):
    """Every scan of a window read and transformed in parallel threads:
    ((W, cap, 4) buffer, (W,) int32 counts)."""
    lib = load_library()
    W = len(paths)
    tfs = _tfs(tfs, W)
    out = np.zeros((W, cap, 4), np.float32)
    counts = np.zeros(W, np.int32)
    names = (ctypes.c_char_p * W)(*[os.fsencode(p) for p in paths])
    lib.load_window(names, W, tfs.ctypes.data_as(_F32P),
                    out.ctypes.data_as(_F32P),
                    counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap)
    bad = [p for p, c in zip(paths, counts) if c < 0]
    if bad:
        raise OSError(f"native loader could not read {bad}")
    return out, counts


def load_scan_transformed_plain(path: str, tf: np.ndarray, cap: int):
    """The numpy route of :func:`load_scan_transformed`, in the loader's
    float32 order of operations."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:cap]
    m = _tfs(tf, 1).reshape(4, 4)
    out = np.zeros((cap, 4), np.float32)
    for r in range(3):
        out[:len(pts), r] = (pts[:, 0] * m[r, 0] + pts[:, 1] * m[r, 1]
                             + pts[:, 2] * m[r, 2] + m[r, 3])
    out[:len(pts), 3] = pts[:, 3]
    return out, len(pts)


def load_window_plain(paths: list[str], tfs: np.ndarray, cap: int):
    """The numpy route of :func:`load_window`."""
    W = len(paths)
    tfs = _tfs(tfs, W)
    out = np.zeros((W, cap, 4), np.float32)
    counts = np.zeros(W, np.int32)
    for i, p in enumerate(paths):
        out[i], counts[i] = load_scan_transformed_plain(p, tfs[i], cap)
    return out, counts
