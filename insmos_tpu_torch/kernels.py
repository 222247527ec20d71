"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The build runs at first use, into
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
              "-Xcompiler", "-fPIC", "-lineinfo"]

_LOADED: dict = {}

# NVIDIA H100 SXM peaks (data sheet, dense rates at the 700 W limit): bf16
# tensor-core FLOP/s and HBM bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of ``flops`` at the bf16 tensor-core peak and ``nbytes`` (each input
    read once, each output written once) at the memory rate. Returns
    ``bound_ms`` and ``bound_by`` ("operations" or "bytes")."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return dict(bound_ms=max(t_ops, t_mem) * 1e3,
                bound_by="operations" if t_ops > t_mem else "bytes")


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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel, wait for every one, and raise if any
    failed. Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    bad = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
           if p.returncode != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} -> {rc}\n{o}" for c, rc, o in bad))
    return "".join(outs)


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, build seconds (0.0 when cached), nvcc output)."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / "libinsmos_kernels.so"
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = [nvcc_path(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
    srcs = [p for p in sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in srcs]
    tmp = out_dir / f"libinsmos_kernels.{tag}.so"
    t0 = time.perf_counter()
    try:
        log = _run_all([nvcc + ["-c", "-o", str(o), str(p)]
                        for p, o in zip(srcs, objs)])
        log += _run_all([nvcc + ["-shared", "-o", str(tmp),
                                 *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, log


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    if "lib" not in _LOADED:
        path, _, _ = build()
        _LOADED["lib"] = ctypes.CDLL(str(path))
    return _LOADED["lib"]


class KernelEntry:
    """One ``extern "C" int`` entry point of the library, bound with ctypes
    at first call, with a launch count per variant.

    Calling it launches the variant's kernel (for some variants a pre-pass
    kernel first) and adds one to ``launches[variant]``: the count is of
    entry calls; a non-zero CUDA error from the launch raises instead."""

    def __init__(self, symbol: str, argtypes: list, variants):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = dict.fromkeys(variants, 0)
        self._fn = None

    def reset_counts(self):
        for k in self.launches:
            self.launches[k] = 0

    def __call__(self, variant: str, *args):
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            raise RuntimeError(
                f"{self.symbol} ({variant}) launch failed: CUDA error {err}")
        self.launches[variant] += 1
