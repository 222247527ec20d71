"""Block-local per-lane gather on the card (port of
tools/micro_lanegather.py, the candidate core of a row-lane sparse conv):

    T7  out[i, l] = op[b * S + idx[i, l], l] for row i of block b = i // S,
        S = 256, 4,096 blocks: three (1,048,576, 128) arrays of 512 MB,
        134M gathers (lane_gather, stride S)

The kernel output is held against its plain version bit for bit, then both
are timed; it prints GB/s moved.

    python -m insmos_tpu_torch.tools.micro_lanegather

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import setup_device
from . import micro_kernels as MK

S, NB = 256, 4096  # tools/micro_lanegather.py:22-23
REPLACES = {"T7": "tools/micro_lanegather.py:32"}


def make_case(S=S, NB=NB, seed=0):
    """The TPU probe's op (float32) and idx (int32 in [0, S)), both
    (NB * S, 128) (:24-25)."""
    rng = np.random.default_rng(seed)
    op = rng.normal(size=(NB * S, 128)).astype(np.float32)
    idx = rng.integers(0, S, (NB * S, 128)).astype(np.int32)
    return op, idx


def main(iters=10):
    setup_device(MK.DEVICE)
    op, idx = make_case()
    MK.check_range(idx, S)
    op, idx = MK.to_device(op, idx)
    n = NB * S * 128
    lane = MK.lane_index(idx, S, S)
    return [MK.run_exact("T7", f"lane gather S={S} x {NB} blocks f32",
                         lambda: MK.lane_gather_cuda(op, idx, S, S),
                         lambda: MK.lane_gather_plain(op, idx, S, S), "lane",
                         MK.gather_gb(n, n), "GB/s", (op, idx),
                         lambda: torch.gather(op, 0, lane), iters)]


def cli(argv=None):
    MK.probe_cli(__doc__, main, argv)


if __name__ == "__main__":
    cli()
