"""The T12 probe kernels (csrc/probe_dot.cu) of one tree, for the turns of
``tools/turns.py``:

    python -m insmos_tpu_torch.tools.turns dot OLD [--out PATH]

``worker`` runs ``probe_dotshapes.SHAPES`` through the tree's ``dot_cuda``,
both variants, at one copy and at one copy per SM: holds the output against
``dot_plain`` (1e-4 x max(1, max|plain|)), then reads the CUDA-event ms and
the device ms (torch.profiler) per call with the given timing helpers.
"""

from __future__ import annotations

ITERS = 10


def worker(timing) -> list[dict]:
    import torch

    from insmos_tpu_torch import setup_device
    from insmos_tpu_torch.tools import probe_dotshapes as PD

    dev = setup_device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, M, K, N, n_dots in PD.SHAPES:
        reps = PD.REP * n_dots
        a, b = (torch.from_numpy(x).to(dev, torch.bfloat16)
                for x in PD.make_operands(M, K, N))
        ref = PD.dot_plain(a, b, reps)
        for v in PD.VARIANTS:
            for c in (1, sms):
                err, scale = timing.max_err(PD.dot_cuda(a, b, reps, v, c),
                                            ref)
                if err > 1e-4 * scale:
                    raise AssertionError(f"{name} {v} copies={c}: "
                                         f"err {err:.3g}")
                fn = lambda: PD.dot_cuda(a, b, reps, v, c)  # noqa: E731
                rows.append(dict(label=f"{name} | {v} | {c}", shape=name,
                                 variant=v, copies=c, err=err,
                                 ms=timing.cuda_ms(fn, ITERS),
                                 device_ms=timing.device_ms(fn, ITERS)))
    return rows
