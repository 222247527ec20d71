"""The work a step needs, counted by the benchmark's own rulebook: the
reference's site sets and pairs (never the program's plans), walked back
from what the step outputs.

A conv's useful pairs are those whose output row is needed: the rows the
step's per-point logits depend on, and every row of the tensor that feeds
the dense bird's-eye view (the heatmap reads all of it). FLOPs are 2 x
pairs x Cin x Cout per sparse conv, plus the dense convs from their
shapes. Bytes of a span conv: its needed input rows read once in the
compute dtype, its needed output rows written once in float32, its
weights read once. The peaks are NVIDIA's data sheet for one H100 SXM:
989 TFLOP/s dense bf16 and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def cone(tape) -> list[dict]:
    """Each conv's useful work on a reference step's tape: name, span op
    or not, pairs, needed input and output rows, cin, cout, taps."""
    need = {r: torch.ones(tape.sizes[r], dtype=torch.bool,
                          device=_device(tape)) for r in tape.roots}
    convs = []

    def mark(tid, rows_mask=None, idx=None):
        if not tid:
            return
        m = need.get(tid)
        if m is None:
            m = need[tid] = torch.zeros(tape.sizes[tid], dtype=torch.bool,
                                        device=_device(tape))
        if rows_mask is not None:
            m |= rows_mask
        if idx is not None and idx.numel():
            m[idx] = True

    for op in reversed(tape.ops):
        nout = need.get(op["out"])
        if nout is None or not bool(nout.any()):
            continue
        kind = op["kind"]
        if kind == "conv":
            n_pairs = 0
            nin = torch.zeros(tape.sizes[op["ins"][0]], dtype=torch.bool,
                              device=nout.device) if op["ins"][0] else None
            for i, o in op["pairs"]:
                sel = nout[o]
                n_pairs += int(sel.sum())
                if nin is not None:
                    nin[i[sel]] = True
            if nin is not None:
                mark(op["ins"][0], rows_mask=nin)
            convs.append(dict(name=op["name"], span=op["span"],
                              pairs=n_pairs, cin=op["cin"], cout=op["cout"],
                              taps=len(op["pairs"]),
                              rows_in=int(nin.sum()) if nin is not None else 0,
                              rows_out=int(nout.sum())))
        elif kind == "pw":
            for tid in op["ins"]:
                mark(tid, rows_mask=nout)
        elif kind == "gather":
            rows = op["rows"]
            sel = (rows >= 0) & nout
            for tid in op["ins"]:
                mark(tid, idx=rows[sel])
        elif kind == "scatter":
            rows = op["rows"]
            ok = rows >= 0
            m = torch.zeros_like(ok)
            m[ok] = nout[rows[ok]]
            for tid in op["ins"]:
                mark(tid, rows_mask=m)
    return convs


def _device(tape):
    for op in tape.ops:
        if op["kind"] == "conv" and op["pairs"]:
            return op["pairs"][0][1].device
    return torch.device("cpu")


def step_work(convs, dense_flops: float, act_bytes: int) -> dict:
    """A step's useful FLOPs, and its span convs' FLOPs, bytes and least
    time on the card (each conv bound by the larger of its FLOPs at the
    peak rate and its bytes at the memory rate)."""
    flops = float(dense_flops)
    span = dict(flops=0.0, bytes=0.0, bound_s=0.0, convs=0)
    for c in convs:
        f = 2.0 * c["pairs"] * c["cin"] * c["cout"]
        flops += f
        if not c["span"]:
            continue
        b = (c["rows_in"] * c["cin"] * act_bytes + c["rows_out"] * c["cout"] * 4
             + c["taps"] * c["cin"] * c["cout"] * act_bytes)
        span["flops"] += f
        span["bytes"] += b
        span["bound_s"] += max(f / PEAK_FLOPS, b / PEAK_BYTES)
        span["convs"] += 1
    return dict(flops=flops, span=span)
