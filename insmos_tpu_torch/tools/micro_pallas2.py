"""Gather forms on the card (port of tools/micro_pallas2.py, whose Pallas
bodies held an (8192, 128) table in VMEM):

    T4  row gather: 1M rows of 128 float32 from an (8192, 128) table
        (gather_rows, width 128)
    T5  per-lane gather over the whole table, take_along_axis on axis 0:
        out[i, l] = table[idx[i, l], l], idx (8192, 128) (lane_gather, one
        window, stride 0)
    T6  per-lane lower bound of (8192, 128) queries in 8,192 sorted keys;
        the TPU probe replicated the keys over 128 lanes so any lane could
        search them, here they are searched as one column (lower_bound)

Each kernel output is held against its plain version bit for bit, then
both are timed; the gathers print GB/s moved, the search millions of
queries per second.

    python -m insmos_tpu_torch.tools.micro_pallas2

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import setup_device
from . import micro_kernels as MK

T, Q = 8192, 1_048_576  # tools/micro_pallas2.py:35
QR = Q // 128           # rows of the per-lane forms (:65)
REPLACES = {"T4": "tools/micro_pallas2.py:44",
            "T5": "tools/micro_pallas2.py:73",
            "T6": "tools/micro_pallas2.py:119"}


def make_case(seed=0, T=T, Q=Q):
    """The TPU probe's arrays, drawn in its order from one generator
    (:32-37, :65-66, :97-99): table, idx (T4); idx2 (T5); keys (column 0 of
    the replicated keys), q2 (T6)."""
    rng = np.random.default_rng(seed)
    qr = Q // 128
    table = rng.normal(size=(T, 128)).astype(np.float32)
    idx = rng.integers(0, T, Q).astype(np.int32)
    idx2 = rng.integers(0, T, (qr, 128)).astype(np.int32)
    keys = np.sort(rng.integers(0, 2**30, T)).astype(np.int32)
    q2 = rng.integers(0, 2**30, (qr, 128)).astype(np.int32)
    return table, idx, idx2, keys, q2


def main(iters=10):
    setup_device(MK.DEVICE)
    case = make_case()
    MK.check_range(case[1], T)
    MK.check_range(case[2], T, "idx2")
    table, idx, idx2, keys, q2 = MK.to_device(*case)
    lane2 = MK.lane_index(idx2, QR, 0)
    return [
        MK.run_exact("T4", f"row gather {Q} x 128 from {T}",
                     lambda: MK.gather_rows_cuda(table, idx),
                     lambda: MK.gather_rows_plain(table, idx), "rows",
                     MK.gather_gb(Q, Q * 128), "GB/s", (table, idx),
                     lambda: torch.index_select(table, 0, idx), iters),
        MK.run_exact("T5", f"lane gather ({QR}, 128) from ({T}, 128)",
                     lambda: MK.lane_gather_cuda(table, idx2, QR, 0),
                     lambda: MK.lane_gather_plain(table, idx2, QR, 0), "lane",
                     MK.gather_gb(QR * 128, QR * 128), "GB/s", (table, idx2),
                     lambda: torch.gather(table, 0, lane2), iters),
        MK.run_exact("T6", f"lower bound of ({QR}, 128) in {T} keys",
                     lambda: MK.lower_bound_cuda(keys, q2),
                     lambda: MK.lower_bound_plain(keys, q2), "bsearch",
                     QR * 128 / 1e6, "Mq/s", (keys, q2),
                     lambda: torch.searchsorted(keys, q2, out_int32=True),
                     iters),
    ]


def cli(argv=None):
    MK.probe_cli(__doc__, main, argv)


if __name__ == "__main__":
    cli()
