"""Gather and binary-search probes on the card (port of
tools/micro_pallas.py, whose Pallas bodies held the table in VMEM):

    T1  out[q] = table[idx[q]], a 1 MB int32 table, 4M queries (gather_rows,
        width 1)
    T2  the lower bound of 4M random queries in 262,144 sorted keys
        (lower_bound)
    T3  a row gather of width 8 from a (262,144, 8) float32 table, 1M rows
        (gather_rows)

Each kernel output is held against its plain version (csrc/micro_gather.cu
against micro_kernels' *_plain) bit for bit, then both are timed; the
gathers print GB/s moved, the search millions of queries per second.

    python -m insmos_tpu_torch.tools.micro_pallas

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import setup_device
from . import micro_kernels as MK

T = 262_144    # table entries (tools/micro_pallas.py:40)
Q = 4_194_304  # queries (:41)
QR = 1_048_576  # row-gather rows (:117)
# the TPU kernel each reading replaces: its pallas_call
REPLACES = {"T1": "tools/micro_pallas.py:53", "T2": "tools/micro_pallas.py:95",
            "T3": "tools/micro_pallas.py:126"}


def make_case(seed=0, T=T, Q=Q, QR=QR):
    """The TPU probe's arrays, drawn in its order from one generator
    (:39-44, :73-74, :116-118): table, idx (T1); keys, queries (T2); feats,
    ridx (T3)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**30, T).astype(np.int32)
    idx = rng.integers(0, T, Q).astype(np.int32)
    keys = np.sort(rng.integers(0, 2**30, T)).astype(np.int32)
    queries = rng.integers(0, 2**30, Q).astype(np.int32)
    feats = rng.normal(size=(T, 8)).astype(np.float32)
    ridx = rng.integers(0, T, QR).astype(np.int32)
    return table, idx, keys, queries, feats, ridx


def main(iters=10):
    setup_device(MK.DEVICE)
    case = make_case()
    MK.check_range(case[1], T)
    MK.check_range(case[5], T, "ridx")
    table, idx, keys, queries, feats, ridx = MK.to_device(*case)
    return [
        MK.run_exact("T1", f"gather {Q} from {T} (width 1)",
                     lambda: MK.gather_rows_cuda(table, idx),
                     lambda: MK.gather_rows_plain(table, idx), "rows",
                     MK.gather_gb(Q, Q), "GB/s", (table, idx),
                     lambda: torch.index_select(table, 0, idx), iters),
        MK.run_exact("T2", f"lower bound of {Q} in {T} keys",
                     lambda: MK.lower_bound_cuda(keys, queries),
                     lambda: MK.lower_bound_plain(keys, queries), "bsearch",
                     Q / 1e6, "Mq/s", (keys, queries),
                     lambda: torch.searchsorted(keys, queries,
                                                out_int32=True), iters),
        MK.run_exact("T3", f"row gather {QR} x 8 from {T}",
                     lambda: MK.gather_rows_cuda(feats, ridx),
                     lambda: MK.gather_rows_plain(feats, ridx), "rows",
                     MK.gather_gb(QR, QR * 8), "GB/s", (feats, ridx),
                     lambda: torch.index_select(feats, 0, ridx), iters),
    ]


def cli(argv=None):
    MK.probe_cli(__doc__, main, argv)


if __name__ == "__main__":
    cli()
