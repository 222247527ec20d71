"""The micro-gather kernels (csrc/micro_gather.cu: gather_rows on T1, T3
and T4, lane_gather on T5 and T7-T9) of one tree, for the turns of
``tools/turns.py``; also gather_rows at widths 3 and 4, which no probe
uses (T3's queries from a table of T3's rows and that width):

    python -m insmos_tpu_torch.tools.turns gather OLD [--out PATH]

``worker`` builds each probe's arrays with the tree's own ``make_case`` at
the TPU probes' full sizes, holds the tree's ``*_cuda`` output against its
``*_plain`` bit for bit, then reads the kernel's CUDA-event ms and device
ms (torch.profiler) per call, and the device ms of the one PyTorch call
that computes the same function (``index_select`` or ``gather``), with the
given timing helpers.
"""

from __future__ import annotations

ITERS = 10


def _cases():
    """(label, kernel, plain, one-call) per case, the arrays of one case on
    the card only while it is read."""
    import numpy as np
    import torch

    from insmos_tpu_torch.tools import micro_kernels as MK
    from insmos_tpu_torch.tools import micro_lanegather as MLG
    from insmos_tpu_torch.tools import micro_lanegather2 as MLG2
    from insmos_tpu_torch.tools import micro_pallas as MP
    from insmos_tpu_torch.tools import micro_pallas2 as MP2
    from insmos_tpu_torch.tools import probe_tala as PT

    def rows(label, table, idx):
        table, idx = MK.to_device(table, idx)
        return (label, lambda: MK.gather_rows_cuda(table, idx),
                lambda: MK.gather_rows_plain(table, idx),
                lambda: torch.index_select(table, 0, idx))

    def lane(label, op, idx, S, stride):
        op, idx = MK.to_device(op, idx)
        ix = MK.lane_index(idx, S, stride)
        return (label, lambda: MK.lane_gather_cuda(op, idx, S, stride),
                lambda: MK.lane_gather_plain(op, idx, S, stride),
                lambda: torch.gather(op, 0, ix))

    table, idx, _, _, feats, ridx = MP.make_case()
    yield rows("T1 gather_rows w1", table, idx)
    yield rows("T3 gather_rows w8", feats, ridx)
    rng = np.random.default_rng(0)
    for width in (3, 4):
        yield rows(f"gather_rows w{width}", rng.normal(
            size=(feats.shape[0], width)).astype(np.float32), ridx)
    del feats, ridx
    table, idx, idx2, _, _ = MP2.make_case()
    yield rows("T4 gather_rows w128", table, idx)
    yield lane("T5 lane_gather", table, idx2, MP2.QR, 0)
    del table, idx, idx2
    yield lane("T7 lane_gather", *MLG.make_case(), MLG.S, MLG.S)
    for S, dtype, NB in MLG2.CASES:
        yield lane(f"T8 lane_gather S={S} NB={NB} {dtype.__name__}",
                   *MLG2.make_case(S, dtype, NB), S, S)
    table, idx = PT.make_case()
    yield lane("T9 lane_gather", table, idx, idx.shape[0], 0)


def worker(timing) -> list[dict]:
    import torch

    from insmos_tpu_torch import setup_device

    setup_device("cuda")
    out = []
    for label, kernel, plain, library in _cases():
        got, ref = kernel(), plain()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"{label}: kernel differs from plain")
        del got, ref
        out.append(dict(label=label, ms=timing.cuda_ms(kernel, ITERS),
                        device_ms=timing.device_ms(kernel, ITERS),
                        library_device_ms=timing.device_ms(library, ITERS)))
        del kernel, plain, library
        torch.cuda.empty_cache()
    return out
