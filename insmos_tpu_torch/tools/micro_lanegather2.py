"""Per-lane gather sweep on the card (port of tools/micro_lanegather2.py,
which searched for a per-lane gather that Mosaic compiles):

    T8  out[i, l] = op[b * S + idx[i, l], l] (block b = i // S) at the TPU
        probe's five cases: S = 8, 32, 128 and 256 rows per block, float32,
        and S = 32 in int32 (lane_gather, stride S)

Each kernel output is held against its plain version bit for bit, then
both are timed; it prints GB/s moved.

    python -m insmos_tpu_torch.tools.micro_lanegather2

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import setup_device
from . import micro_kernels as MK

# S, dtype, NB (tools/micro_lanegather2.py:50-54)
CASES = [(8, np.float32, 64), (32, np.float32, 64), (32, np.int32, 64),
         (128, np.float32, 64), (256, np.float32, 8)]
REPLACES = {"T8": "tools/micro_lanegather2.py:28"}


def make_case(S, dtype, NB=64, seed=0):
    """op (NB * S, 128) standard normal cast to ``dtype`` (an int32 op holds
    the truncated normals, as the TPU probe's did) and idx int32 in [0, S)
    (:20-21)."""
    rng = np.random.default_rng(seed)
    op = rng.normal(size=(NB * S, 128)).astype(dtype)
    idx = rng.integers(0, S, (NB * S, 128)).astype(np.int32)
    return op, idx


def run_case(S, dtype, NB, iters=10):
    op, idx = make_case(S, dtype, NB)
    MK.check_range(idx, S)
    op, idx = MK.to_device(op, idx)
    n = NB * S * 128
    lane = MK.lane_index(idx, S, S)
    return MK.run_exact("T8", f"lane gather S={S} x {NB} blocks "
                        f"{np.dtype(dtype).name}",
                        lambda: MK.lane_gather_cuda(op, idx, S, S),
                        lambda: MK.lane_gather_plain(op, idx, S, S), "lane",
                        MK.gather_gb(n, n), "GB/s", (op, idx),
                        lambda: torch.gather(op, 0, lane), iters)


def main(iters=10):
    setup_device(MK.DEVICE)
    return [run_case(*c, iters=iters) for c in CASES]


def cli(argv=None):
    MK.probe_cli(__doc__, main, argv)


if __name__ == "__main__":
    cli()
