"""Probes of the port's kernels on the card (counterparts of the JAX
package's ``tools/`` probes that reach a Pallas kernel), and the timing
helpers they and ``chip_smoke.py`` share.

    python -m insmos_tpu_torch.tools.probe_extract [--production]
    python -m insmos_tpu_torch.tools.probe_dotshapes [--sweep]
    python -m insmos_tpu_torch.tools.turns dot|gather|extract|rowconv|bsearch \
        OLD_ROOT
    python -m insmos_tpu_torch.tools.micro_pallas
    python -m insmos_tpu_torch.tools.micro_pallas2
    python -m insmos_tpu_torch.tools.micro_lanegather
    python -m insmos_tpu_torch.tools.micro_lanegather2
    python -m insmos_tpu_torch.tools.probe_tala
    python -m insmos_tpu_torch.tools.probe_pallas_rowconv
    python -m insmos_tpu_torch.tools.measure_train_step [--profile]

Every time they print is a reading of the card named on their first line.
"""

from __future__ import annotations

import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls after one warm-up
    call, timed with CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def event_device_us(ev) -> float:
    """Self device µs of one torch.profiler ``key_averages()`` entry."""
    return float(getattr(ev, "self_device_time_total", None)
                 or getattr(ev, "self_cuda_time_total", 0.0))


# device_ms's profiling sessions in this process: whole, short (run again),
# and calls timed by CUDA events after every session came back short
SESSIONS = {"whole": 0, "short": 0, "events": 0}


def device_ms(fn, reps: int = 10, tries: int = 4) -> float:
    """Device ms per call of ``fn()``: torch.profiler's self device time of
    every kernel, copy and set the ``reps`` calls ran (after one warm-up
    call), divided by ``reps``. Unlike ``cuda_ms`` it does not read the
    host time between launches.

    ``fn`` must run at least one device activity a call. A profiling
    session that records fewer than ``reps`` of them (now and then CUPTI
    hands back none) is run again, up to ``tries`` sessions; if none of
    them is whole, the time comes from CUDA events (``cuda_ms``) and a
    note says so on stderr. ``SESSIONS`` counts each outcome."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        us = sum(event_device_us(ev) for ev in evs)
        if sum(ev.count for ev in evs) >= reps and us > 0:
            SESSIONS["whole"] += 1
            return us / 1e3 / reps
        SESSIONS["short"] += 1
    SESSIONS["events"] += 1
    print(f"device_ms: {tries} profiling sessions recorded fewer than "
          f"{reps} device activities; timed by CUDA events instead",
          file=sys.stderr, flush=True)
    return cuda_ms(fn, reps)


def max_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max(1, max |ref|)): the error and the scale the
    probes' tolerances are relative to."""
    return (float((got - ref).abs().max()),
            max(1.0, float(ref.abs().max())))
