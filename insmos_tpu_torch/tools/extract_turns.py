"""The T10 extraction-probe kernels (csrc/probe_extract.cu) of one tree, for
the turns of ``tools/turns.py``:

    python -m insmos_tpu_torch.tools.turns extract OLD [--out PATH]

``worker`` runs the tree's ``probe_extract.main()``: every variant at the
TPU probe's four cases, each held against ``extract_plain`` (5e-4 x max(1,
max|plain|)), then read by CUDA events and by device time (torch.profiler)
per call. One reading per case and variant, and one per variant summed
over the cases, each with the one-call's device ms where the tree reads it.
"""

from __future__ import annotations


def worker(timing) -> list[dict]:
    from insmos_tpu_torch.tools import probe_extract as PE

    res = PE.main()
    rows = []
    for r in res:
        for v, x in r["variants"].items():
            rows.append(dict(label=f"{r['name']} | {v}", ms=x["ms"],
                             device_ms=x["device_ms"], err=x["err"],
                             library_device_ms=r.get("library_device_ms")))
    for v in res[0]["variants"]:
        lib = [r.get("library_device_ms") for r in res]
        rows.append(dict(
            label=f"sum of {len(res)} cases | {v}",
            ms=sum(r["variants"][v]["ms"] for r in res),
            device_ms=sum(r["variants"][v]["device_ms"] for r in res),
            library_device_ms=None if None in lib else sum(lib)))
    return rows
