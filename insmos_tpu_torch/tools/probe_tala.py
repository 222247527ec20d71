"""take_along_axis probe on the card (port of tools/probe_tala.py, which
checked what Mosaic makes of a per-lane gather):

    T9  out[i, l] = table[idx[i, l], l], table (16, 128) float32 holding
        0 .. 2047, idx (8, 128) in [0, 16) (lane_gather, one window, stride
        0)

The kernel output is held against its plain version bit for bit, then both
are timed (a launch-bound size: 4 KB of output).

    python -m insmos_tpu_torch.tools.probe_tala

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import setup_device
from . import micro_kernels as MK

T = 16  # tools/probe_tala.py:8
REPLACES = {"T9": "tools/probe_tala.py:15"}


def make_case(seed=0):
    """The TPU probe's table (T, 128) = arange and idx (8, 128) (:7-10)."""
    rng = np.random.default_rng(seed)
    table = np.arange(T * 128).reshape(T, 128).astype(np.float32)
    idx = rng.integers(0, T, (8, 128)).astype(np.int32)
    return table, idx


def main(iters=10):
    setup_device(MK.DEVICE)
    table, idx = make_case()
    MK.check_range(idx, T)
    table, idx = MK.to_device(table, idx)
    rows = idx.shape[0]
    lane = MK.lane_index(idx, rows, 0)
    return [MK.run_exact("T9", f"take_along_axis ({rows}, 128) from "
                         f"({T}, 128)",
                         lambda: MK.lane_gather_cuda(table, idx, rows, 0),
                         lambda: MK.lane_gather_plain(table, idx, rows, 0),
                         "lane", MK.gather_gb(idx.numel(), idx.numel()),
                         "GB/s", (table, idx),
                         lambda: torch.gather(table, 0, lane), iters)]


def cli(argv=None):
    MK.probe_cli(__doc__, main, argv)


if __name__ == "__main__":
    cli()
