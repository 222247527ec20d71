"""Where the streaming step's time goes on the card: its wall time and, by
torch.profiler, its device time, split by kernel.

    python -m insmos_tpu_torch.tools.profile_step [--steps 2] [--out PATH]

Streams the ref-exact HDL-64E stream (``data.hdl64.make_stream``, seed 0)
through ``InferencePipeline.push_scan`` at the full default Config with
random weights (``init_params``, seed 0): the first full window warms up,
then 3 full-window steps are timed on the host clock (each ends in a host
fetch of its outputs and a synchronize), then ``--steps`` more run under
``torch.profiler``. Prints one JSON object: the clean step times, the
device time per profiled step (all kernels, copies and sets), the span
kernels' share of it, kernel launches per step, the idle share (1 - device
time / median clean step), the top kernels by device time and every span
kernel instantiation; ``--out`` also writes it to PATH. Needs one CUDA
device; every time is a reading of the card named in the output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import setup_device
from ..config import Config
from ..data.hdl64 import make_stream
from ..pipeline import InferencePipeline
from ..utils.params import init_params, make_model
from . import card_line
from . import event_device_us as _device_us

SPAN_KERNELS = ("span_mma_kernel", "span_conv_kernel")
N_CLEAN = 3


def _step(pipe, scan, tf):
    out = pipe.push_scan(scan, tf)
    InferencePipeline.fetch(out, len(scan))
    torch.cuda.synchronize()


def profile_step(steps: int = 2) -> dict:
    device = setup_device("cuda")
    cfg = Config()
    params, state = init_params(cfg, np.random.default_rng(0))
    pipe = InferencePipeline(cfg, make_model(cfg, params, state, device),
                             device)
    W = cfg.model.n_past_steps
    scans, tfs = make_stream(cfg, W + N_CLEAN + steps, seed=0)
    for s, tf in zip(scans[:W], tfs[:W]):
        _step(pipe, s, tf)
    clean = []
    for s, tf in zip(scans[W:W + N_CLEAN], tfs[W:W + N_CLEAN]):
        t0 = time.perf_counter()
        _step(pipe, s, tf)
        clean.append((time.perf_counter() - t0) * 1e3)
    rest = list(zip(scans[W + N_CLEAN:], tfs[W + N_CLEAN:]))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s, tf in rest:
            _step(pipe, s, tf)
    prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    total_us = sum(_device_us(ev) for ev in kern)
    span = [ev for ev in kern if any(k in ev.key for k in SPAN_KERNELS)]
    span_us = sum(_device_us(ev) for ev in span)
    top = sorted(kern, key=_device_us, reverse=True)[:15]
    med = statistics.median(clean)
    return dict(
        card=card_line(), steps=steps, clean_step_ms=clean,
        clean_step_median_ms=med, profiled_step_wall_ms=prof_ms,
        device_ms_per_step=total_us / 1e3 / steps,
        span_kernel_ms_per_step=span_us / 1e3 / steps,
        device_launches_per_step=sum(ev.count for ev in kern) / steps,
        idle_share=1.0 - total_us / 1e3 / steps / med,
        top=[_row(ev, steps) for ev in top],
        span_kernels=[_row(ev, steps) for ev in span],
    )


def _row(ev, steps):
    return dict(name=ev.key[:90], ms_per_step=_device_us(ev) / 1e3 / steps,
                calls_per_step=ev.count / steps)


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    res = profile_step(args.steps)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    cli()
