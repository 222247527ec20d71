"""The lower_bound kernel (csrc/micro_gather.cu) of one tree on T2 and T6,
for the turns of ``tools/turns.py``:

    python -m insmos_tpu_torch.tools.turns bsearch OLD [--out PATH]

``worker`` builds each probe's keys and queries with the tree's own
``make_case`` at the TPU probes' full sizes (T2: 4M queries in 262,144
keys; T6: (8192, 128) queries in 8,192 keys), holds the tree's
``lower_bound_cuda`` against ``lower_bound_plain`` bit for bit, then reads
the kernel's CUDA-event ms and device ms (torch.profiler) per call, and the
device ms of ``torch.searchsorted`` on the same inputs. One reading per
probe and one for their sum.
"""

from __future__ import annotations

ITERS = 20


def _cases():
    """(label, keys, queries) of T2 and T6 as numpy arrays."""
    from insmos_tpu_torch.tools import micro_pallas as MP
    from insmos_tpu_torch.tools import micro_pallas2 as MP2

    _, _, keys, queries, _, _ = MP.make_case()
    yield "T2 lower_bound", keys, queries
    _, _, _, keys, queries = MP2.make_case()
    yield "T6 lower_bound", keys, queries


def worker(timing) -> list[dict]:
    import torch

    from insmos_tpu_torch import setup_device
    from insmos_tpu_torch.tools import micro_kernels as MK

    setup_device("cuda")
    rows = []
    for label, keys, queries in _cases():
        keys, queries = MK.to_device(keys, queries)
        kernel = lambda: MK.lower_bound_cuda(keys, queries)  # noqa: E731
        if not torch.equal(kernel(), MK.lower_bound_plain(keys, queries)):
            raise AssertionError(f"{label}: kernel differs from plain")
        rows.append(dict(
            label=label, ms=timing.cuda_ms(kernel, ITERS),
            device_ms=timing.device_ms(kernel, ITERS),
            library_device_ms=timing.device_ms(
                lambda: torch.searchsorted(keys, queries, out_int32=True),
                ITERS)))
    return rows + [summed(rows)]


def summed(rows: list[dict]) -> dict:
    """One reading that sums the probes' readings, key by key."""
    return dict(label=f"sum of {len(rows)} probes",
                **{key: sum(r[key] for r in rows)
                   for key in ("ms", "device_ms", "library_device_ms")})
