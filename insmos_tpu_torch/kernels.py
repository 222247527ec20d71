"""Build and load the package's CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a into one shared library with
a plain C interface, loaded with ctypes. The build runs at first use, into
``insmos_tpu_torch/_build/<source hash>/``, so a changed source rebuilds
and an unchanged one is loaded as built. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LOADED: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, build seconds (0.0 when cached), nvcc output)."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / "libinsmos_kernels.so"
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libinsmos_kernels.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *[str(p) for p in sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, lib)
    return lib, dt, res.stdout + res.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    if "lib" not in _LOADED:
        path, _, _ = build()
        _LOADED["lib"] = ctypes.CDLL(str(path))
    return _LOADED["lib"]
