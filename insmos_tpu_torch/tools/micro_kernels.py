"""The gather and search kernels of the micro probes (csrc/micro_gather.cu),
each beside its plain PyTorch version, and the runner the probes share.

    gather_rows   out[q] = table[idx[q]]                      T1, T3, T4
    lower_bound   the left lower bound of each query          T2, T6
    lane_gather   out[i, l] = op[(i // S) * stride + idx[i, l], l]
                                                              T5, T7, T8, T9

``*_plain`` is the plain version (index_select, searchsorted, gather) that
the CPU tests hold against the TPU probes' bodies. ``*_cuda`` launches the
kernel once on the current stream; it takes CUDA tensors only, of 4-byte
elements (float32 or int32, copied bit for bit) and int32 indices. The
``rows`` and ``lane`` kernels use 32-bit offsets: their wrappers raise
ValueError for a table or output of more than 2^30 elements.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..kernels import KernelEntry, bound
from ..sparse import span_conv as SC
from . import card_line, cuda_ms, device_ms, max_err

DEVICE = torch.device("cuda")
VARIANTS = ("rows", "bsearch", "lane")
NAMES = {"rows": "gather_rows", "bsearch": "lower_bound",
         "lane": "lane_gather"}
SOURCE = "insmos_tpu_torch/csrc/micro_gather.cu"
ELEM_TYPES = (torch.float32, torch.int32)

MAX_ELEMS = 2**30  # rows and lane: elements of each array (32-bit offsets)

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# src, idx, out; n, src_rows; width, S; stride; variant; stream
KERNEL = KernelEntry("micro_gather",
                     [_p] * 3 + [_l] * 2 + [_i] * 2 + [_l, _i, _p], VARIANTS)


def gather_rows_plain(table, idx):
    """table[idx] along axis 0: (Q,) + table.shape[1:]."""
    return table.index_select(0, idx)


def lower_bound_plain(keys, q):
    """The first index i with keys[i] >= q (len(keys) if none), int32, in
    q's shape."""
    return torch.searchsorted(keys, q, side="left", out_int32=True)


def lane_index(idx, S, stride):
    """The absolute int64 row index (i // S) * stride + idx[i, l]."""
    base = torch.arange(idx.shape[0], device=idx.device) // S * stride
    return base[:, None] + idx.long()


def lane_gather_plain(op, idx, S, stride):
    """out[i, l] = op[(i // S) * stride + idx[i, l], l]."""
    return torch.gather(op, 0, lane_index(idx, S, stride))


def _need_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def _check_elems(t, name, shape, dev):
    if t.dtype not in ELEM_TYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{ELEM_TYPES}")
    SC._check(t, name, t.dtype, shape, dev)


def _check_size(*tensors):
    if any(t.numel() > MAX_ELEMS for t in tensors):
        raise ValueError(f"arrays of more than 2^30 elements: "
                         f"{[tuple(t.shape) for t in tensors]}")


def _launch(variant, src, idx, out, n, src_rows, width, S=1, stride=0):
    KERNEL(variant, src.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
           src_rows, width, S, stride, VARIANTS.index(variant),
           torch.cuda.current_stream(src.device).cuda_stream)


def gather_rows_cuda(table, idx):
    """The ``rows`` kernel (same contract as gather_rows_plain): table (T,)
    or (T, width), idx (Q,) int32 in [0, T); table and output of at most
    2^30 elements each."""
    _need_cuda("gather_rows_cuda", table)
    dev = table.device
    if table.dim() not in (1, 2) or table.shape[0] == 0:
        raise ValueError(f"table shape {tuple(table.shape)}: expected (T,) "
                         "or (T, width), T >= 1")
    _check_elems(table, "table", table.shape, dev)
    SC._check(idx, "idx", torch.int32, (idx.numel(),), dev)
    out = torch.empty((idx.numel(),) + table.shape[1:], dtype=table.dtype,
                      device=dev)
    _check_size(table, out)
    width = table[0].numel()
    if out.numel():
        _launch("rows", table, idx, out, idx.numel(), table.shape[0], width)
    return out


def lower_bound_cuda(keys, q):
    """The ``bsearch`` kernel (same contract as lower_bound_plain): keys
    (T,) int32 sorted, T >= 1; q int32 of any shape."""
    _need_cuda("lower_bound_cuda", keys)
    dev = keys.device
    if keys.dim() != 1 or not 1 <= keys.shape[0] <= 2**30:
        raise ValueError(f"keys shape {tuple(keys.shape)}: expected (T,), "
                         "1 <= T <= 2^30")
    SC._check(keys, "keys", torch.int32, keys.shape, dev)
    SC._check(q, "q", torch.int32, q.shape, dev)
    out = torch.empty(q.shape, dtype=torch.int32, device=dev)
    if out.numel():
        _launch("bsearch", keys, q, out, q.numel(), keys.shape[0], 1)
    return out


def lane_gather_cuda(op, idx, S, stride):
    """The ``lane`` kernel (same contract as lane_gather_plain): op
    (op_rows, L), idx (rows, L) int32 with values in [0, stride), or in
    [0, op_rows) when stride is 0; windows of S rows of idx, window b at op
    row b * stride; op and output of at most 2^30 elements each."""
    _need_cuda("lane_gather_cuda", op)
    dev = op.device
    if op.dim() != 2 or idx.dim() != 2 or op.shape[0] == 0:
        raise ValueError(f"op {tuple(op.shape)} and idx {tuple(idx.shape)}: "
                         "expected (op_rows >= 1, L) and (rows, L)")
    rows, L = idx.shape
    _check_elems(op, "op", (op.shape[0], L), dev)
    SC._check(idx, "idx", torch.int32, (rows, L), dev)
    if S < 1 or stride < 0 or -(-rows // S) * stride > op.shape[0]:
        raise ValueError(f"S={S} stride={stride}: the windows of {rows} rows "
                         f"must lie in op's {op.shape[0]} rows")
    out = torch.empty((rows, L), dtype=op.dtype, device=dev)
    _check_size(op, out)
    if out.numel():
        _launch("lane", op, idx, out, rows, op.shape[0], L, S, stride)
    return out


def check_range(idx, hi, name="idx"):
    """Raise unless every index lies in [0, hi): the kernels do not clamp.
    For the probes' numpy inputs, once, before they go to the card."""
    if idx.size and (idx.min() < 0 or idx.max() >= hi):
        raise ValueError(f"{name} outside [0, {hi})")


def to_device(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
            for a in arrays]


def run_exact(tag, name, kernel, plain, variant, amount, unit, inputs,
              library, iters=10):
    """``kernel()`` (one launch of ``variant``) against ``plain()`` bit for
    bit, then both timed with CUDA events, and ``library()``, one PyTorch
    call that computes the same function, beside them; the kernel and
    ``library()`` also by device time (``device_ms``, torch.profiler), which
    does not read the host time between launches. ``amount`` is the work of
    one call in GB moved or in millions of queries; ``unit`` names its rate
    (from device time). The bound counts the bytes of ``inputs`` read once
    and of the output written once. Returns the reading."""
    before = KERNEL.launches[variant]
    got, ref = kernel(), plain()
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, got))
    if (got.shape != ref.shape or got.dtype != ref.dtype
            or not torch.equal(got.view(torch.int32), ref.view(torch.int32))):
        bad = (int((got.view(torch.int32) != ref.view(torch.int32)).sum())
               if got.shape == ref.shape else ref.numel())
        raise AssertionError(f"{tag} {name}: kernel differs from plain in "
                             f"{bad} of {ref.numel()} elements")
    err = max_err(got, ref)[0]
    del got, ref
    ms = cuda_ms(kernel, iters)
    dev_ms = device_ms(kernel, iters)
    plain_ms = cuda_ms(plain, iters)
    library_ms = cuda_ms(library, iters)
    library_dev_ms = device_ms(library, iters)
    res = dict(tag=tag, name=name, kernel=NAMES[variant], source=SOURCE,
               ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_device_ms=library_dev_ms,
               max_abs_err=err, launches=KERNEL.launches[variant] - before,
               unit=unit, rate=amount / dev_ms * 1e3,
               plain_rate=amount / plain_ms * 1e3, **bound(nbytes))
    print(f"{tag} {name:44s} {ms:9.4f} ms, device {dev_ms:9.4f} ms "
          f"{res['rate']:9.1f} {unit}  plain {plain_ms:9.4f} ms  library "
          f"{library_ms:9.4f} ms, device {library_dev_ms:9.4f} ms  bound "
          f"{res['bound_ms']:9.4f} ms", flush=True)
    return res


def gather_gb(n_idx, n_out):
    """GB a gather of 4-byte elements moves: ``n_idx`` indices read, and
    ``n_out`` output elements each read from its table and written once."""
    return (4 * n_idx + 8 * n_out) / 1e9


def probe_cli(doc, main, argv=None):
    """The command line of a micro probe: print the card, run ``main``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(card_line(), flush=True)
    main()
