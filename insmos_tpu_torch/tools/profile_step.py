"""Where the streaming step's time goes on the card: its wall time and, by
torch.profiler, its device time, split by kernel.

    python -m insmos_tpu_torch.tools.profile_step [--steps 2] [--pod S]
        [--incremental] [--out PATH]

Streams the ref-exact HDL-64E stream (``data.hdl64.make_stream``, seed 0)
through ``InferencePipeline.push_scan`` at the full default Config with
random weights (``init_params``, seed 0): the first full window warms up,
then 3 full-window steps are timed on the host clock (each ends in a host
fetch of its outputs and a synchronize), then ``--steps`` more run under
``torch.profiler``. ``--incremental`` runs the fixed-frame incremental mode
on ``make_fixed_frame_stream`` instead; ``--pod S`` a
``PodInferencePipeline`` of S slots on one card (slot i on seed i's
stream), each step a pod step of all slots. Prints one JSON object: the
clean step times, the device time per profiled step (all kernels, copies
and sets), the span kernels' share of it, kernel launches per step, the idle
share (1 - device time / median clean step), the top kernels by device time
and every span kernel instantiation; ``--out`` also writes it to PATH.
Needs one CUDA device; every time is a reading of the card named in the
output.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from ..data.hdl64 import make_fixed_frame_stream, make_stream
from ..pipeline import InferencePipeline, PodInferencePipeline
from ..utils.params import init_params, make_model
from . import card_line
from . import event_device_us as _device_us

SPAN_KERNELS = ("span_mma_kernel", "span_conv_kernel")
N_CLEAN = 3


def _streams(cfg, n: int, slots: int, incremental: bool):
    """(scans, tfs) of each slot's stream (one for the single stream)."""
    if incremental:
        return [make_fixed_frame_stream(cfg, n, seed=i)[:2]
                for i in range(slots)]
    return [make_stream(cfg, n, seed=i) for i in range(slots)]


def profile_step(steps: int = 2, pod: int = 0,
                 incremental: bool = False) -> dict:
    device = setup_device("cuda")
    cfg = Config()
    if incremental:
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, incremental_stem=True))
    params, state = init_params(cfg, np.random.default_rng(0))
    model = make_model(cfg, params, state, device)
    W = cfg.model.n_past_steps
    streams = _streams(cfg, W + N_CLEAN + steps, max(pod, 1), incremental)
    if pod:
        pipe = PodInferencePipeline(cfg, model, [device], pod)

        def step(t):
            scans = [sc[t] for sc, _ in streams]
            out = pipe.push_scans(scans, [tf[t] for _, tf in streams])
            for i, sc in enumerate(scans):
                pipe.fetch(out, i, len(sc))
            torch.cuda.synchronize()
    else:
        pipe = InferencePipeline(cfg, model, device)

        def step(t):
            scan, tf = streams[0][0][t], streams[0][1][t]
            InferencePipeline.fetch(pipe.push_scan(scan, tf), len(scan))
            torch.cuda.synchronize()

    for t in range(W):
        step(t)
    clean = []
    for t in range(W, W + N_CLEAN):
        t0 = time.perf_counter()
        step(t)
        clean.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(W + N_CLEAN, W + N_CLEAN + steps):
            step(t)
    prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    total_us = sum(_device_us(ev) for ev in kern)
    span = [ev for ev in kern if any(k in ev.key for k in SPAN_KERNELS)]
    span_us = sum(_device_us(ev) for ev in span)
    top = sorted(kern, key=_device_us, reverse=True)[:15]
    med = statistics.median(clean)
    return dict(
        card=card_line(), steps=steps, pod_slots=pod,
        mode="incremental" if incremental else "ref-exact",
        clean_step_ms=clean,
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
    ap.add_argument("--pod", type=int, default=0,
                    help="profile a pod step of this many slots")
    ap.add_argument("--incremental", action="store_true",
                    help="the fixed-frame incremental mode")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    res = profile_step(args.steps, args.pod, args.incremental)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    cli()
