"""The gather and search kernels of the micro probes (csrc/micro_gather.cu),
each beside its plain PyTorch version, and the runner the probes share.

    gather_rows   out[q] = table[idx[q]]                      T1, T3, T4
    lower_bound   the left lower bound of each query          T2, T6
                  (keys in buckets of 2^s; a tree of the buckets' first
                  keys in BFS order, searched in shared memory; the
                  answer's bucket finished from global memory: one 32-byte
                  sector a query at T2, nothing at T6)
    lane_gather   out[i, l] = op[(i // S) * stride + idx[i, l], l]
                                                              T5, T7, T8, T9

``*_plain`` is the plain version (index_select, searchsorted, gather) that
the CPU tests hold against the TPU probes' bodies. ``*_cuda`` calls the
library's entry once on the current stream: one kernel, and for
``lower_bound`` with buckets of more than one key (T2) the tree's pre-pass
before it; the launch count (``KERNEL.launches``) counts entry calls. It
takes CUDA tensors only, of 4-byte
elements (float32 or int32, copied bit for bit) and int32 indices. The
``rows`` and ``lane`` kernels use 32-bit offsets: their wrappers raise
ValueError for a table or output of more than 2^30 elements.
``lower_bound_mirror`` repeats the search kernel's layout and index
arithmetic in torch (``lower_bound_layout``, ``lower_bound_tree``) so that
the CPU tests hold it against ``lower_bound_plain``.
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

TREE_LEVELS = 15  # lower_bound: levels of the splitter tree at most

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# src, idx, out, scratch; n, src_rows; width, S; stride; variant; stream
KERNEL = KernelEntry("micro_gather",
                     [_p] * 4 + [_l] * 2 + [_i] * 2 + [_l, _i, _p], VARIANTS)


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


def _launch(variant, src, idx, out, n, src_rows, width, S=1, stride=0,
            scratch=None):
    KERNEL(variant, src.data_ptr(), idx.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), n, src_rows,
           width, S, stride, VARIANTS.index(variant),
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
        s, h = lower_bound_layout(keys.shape[0])
        # the tree's scratch where buckets hold more than one key
        tree = torch.empty(1 << h, dtype=torch.int32, device=dev) if s \
            else None
        _launch("bsearch", keys, q, out, q.numel(), keys.shape[0], 1,
                scratch=tree)
    return out


# The search's layout and index arithmetic (csrc/micro_gather.cu,
# bs_layout, tree_node, tree_slot and lower_bound_kernel), kept in torch for
# the CPU tests.

def lower_bound_layout(T):
    """(s, h) for T keys: buckets of 2^s keys, s the least that leaves at
    most 2^15 buckets; the first key of each bucket but the first is a
    splitter, and the splitters fill a tree of h levels (2^h >= buckets)."""
    s = max(0, (T - 1).bit_length() - TREE_LEVELS)
    return s, ((T - 1) >> s).bit_length()


def tree_rank(i, h):
    """The in-order rank of BFS node i >= 1 (children 2i, 2i + 1) of a tree
    of h levels."""
    d = torch.floor(torch.log2(i.double())).long()
    return (2 * (i - (1 << d)) + 1) << (h - 1 - d)


def tree_slot(r, h):
    """The BFS node of in-order rank r >= 1 (tree_rank's inverse)."""
    t = torch.zeros_like(r)
    while bool(((r >> t) & 1 == 0).any()):
        t = t + ((r >> t) & 1 == 0).long()
    return (1 << (h - 1 - t)) + (r >> (t + 1))


def lower_bound_tree(keys):
    """The kernel's tree, 2^h int64 values: node 0 keys[0], node i the
    splitter keys[rank(i) * 2^s], INT_MAX past the last bucket. Built as
    the kernel builds it: by node where buckets hold more than one key (the
    tree_build_kernel), by rank from the contiguous keys where they hold
    one (each block)."""
    T = keys.numel()
    s, h = lower_bound_layout(T)
    big = torch.iinfo(torch.int32).max
    tree = torch.full((1 << h,), big, dtype=torch.int64)
    tree[0] = keys[0]
    if s:
        i = torch.arange(1, 1 << h)
        k = tree_rank(i, h) << s
        ok = k < T
        tree[i[ok]] = keys[k[ok]].long()
    else:
        r = torch.arange(1, T)
        tree[tree_slot(r, h)] = keys[1:].long()
    return tree


def lower_bound_mirror(keys, q):
    """The kernel's search in torch (same contract as lower_bound_plain):
    h steps i = 2i + (tree[i] < v) from i = 1; c = i - 2^h splitters lie
    below v, so the answer lies in bucket c: from keys[0] alone where
    buckets hold one key, else by halvings of the bucket down to a group of
    min(2^s, 8) keys and a count of those below v."""
    T = keys.numel()
    s, h = lower_bound_layout(T)
    tree = lower_bound_tree(keys)
    v = q.reshape(-1).long()
    node = torch.ones_like(v)
    for _ in range(h):
        node = 2 * node + (tree[node] < v).long()
    c = node - (1 << h)
    if s == 0:
        ans = c + ((c > 0) | (tree[0] < v)).long()
        return ans.int().reshape(q.shape)
    big = torch.iinfo(torch.int32).max
    pad = torch.cat([keys.long(), torch.full((8,), big, dtype=torch.int64)])

    def key_at(i):
        return pad[i.clamp(max=T)]

    pos = c << s
    half = 1 << (s - 1)
    while half >= 8:
        pos = pos + torch.where(key_at(pos + half - 1) < v, half, 0)
        half >>= 1
    ans = pos.clone()
    for e in range(min(1 << s, 8)):
        ans += (key_at(pos + e) < v).long()
    return ans.int().reshape(q.shape)


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
    """``kernel()`` (one call of ``variant``'s entry, counted once in
    ``launches`` also where the entry runs a pre-pass) against ``plain()``
    bit for bit, then both timed with CUDA events, and ``library()``, one PyTorch
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
