"""The T11 rowconv kernel (csrc/rowconv.cu) of one tree, for the turns of
``tools/turns.py``:

    python -m insmos_tpu_torch.tools.turns rowconv OLD [--out PATH]

``worker`` runs the tree's ``probe_pallas_rowconv.main()``: the kernel at
the TPU probe's two cases, each held against ``rowconv_plain`` (1e-4 x
max(1, max|plain|)), then read by CUDA events and by device time
(torch.profiler) per call. One reading per case and one for their sum; no
one PyTorch call computes the conv.
"""

from __future__ import annotations


def worker(timing) -> list[dict]:
    from insmos_tpu_torch.tools import probe_pallas_rowconv as RC

    rows = [dict(label=r["name"], ms=r["ms"], device_ms=r["device_ms"],
                 err=r["max_abs_err"]) for r in RC.main()]
    rows.append(dict(label=f"sum of {len(rows)} cases",
                     ms=sum(r["ms"] for r in rows),
                     device_ms=sum(r["device_ms"] for r in rows)))
    return rows
