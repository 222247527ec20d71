"""Full-scale training measurement (the port's counterpart of the JAX
package's tools/measure_train_step.py).

Train steps at the full default Config on one device: a window of raycast
HDL-64E scans (data.hdl64.make_hdl64_window, the JAX package's drop-in for
bench.make_window), random labels (``--labels raycast``: the raycast's
moving labels) and four boxes, as the JAX tool feeds. Prints the first
step's and the steady steps' seconds (synchronised), the peak device
memory (``torch.cuda.max_memory_allocated``), the four losses of each step
and the gates, and epochs/day against the reference schedule (160 epochs
of ~19k KITTI train samples). ``--profile`` takes one more step under
torch.profiler (on the card): its device time, the idle share of its wall
time, its kernel launches and the kernels with the most device time.

    python -m insmos_tpu_torch.tools.measure_train_step [--batch 1]
        [--iters 3] [--labels random|raycast] [--dtype bfloat16|float32]
        [--device cuda] [--profile] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

REF_EPOCH_SAMPLES = 19_130  # KITTI sequences 00-07, 09, 10 (approx)
REF_EPOCHS = 160
GATES = ("motion_dropped", "unet_dropped", "voxelizer_capacity_dropped")
BOXES = np.array(
    [[10, 5, -0.8, 4.5, 1.9, 1.6, 0.3, 1],
     [-8, 2, -0.9, 4.2, 1.8, 1.5, 1.1, 1],
     [3, -12, -0.7, 0.8, 0.8, 1.7, 0.0, 2],
     [15, 8, -0.8, 1.8, 0.7, 1.6, 2.0, 3]], np.float32)


def train_sample(cfg, seed: int = 0, labels: str = "random") -> dict:
    """The measured window: make_hdl64_window with ``labels`` "random"
    (uniform over the 3 classes, the JAX tool's) or "raycast" (its moving
    labels), and the four boxes."""
    from ..data.hdl64 import make_hdl64_window

    sample = make_hdl64_window(cfg, seed=seed)
    if labels == "random":
        W, P = sample["points"].shape[:2]
        sample["labels"] = np.random.default_rng(seed).integers(
            0, 3, (W, P)).astype(np.int32)
    sample["gt_boxes"][:4] = BOXES
    sample["num_boxes"] = np.int32(4)
    return sample


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _profiled(run) -> dict:
    """Device time, launches and top kernels of ``run()`` (one step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import event_device_us

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    dev = sum(event_device_us(ev) for ev in kern) / 1e6
    top = sorted(kern, key=event_device_us, reverse=True)[:15]
    return dict(wall_s=wall, device_s=dev, idle_share=1.0 - dev / wall,
                launches=sum(ev.count for ev in kern),
                top=[dict(name=ev.key[:90], ms=event_device_us(ev) / 1e3,
                          calls=ev.count) for ev in top])


def measure(cfg, device="cuda", batch: int = 1, iters: int = 3,
            labels: str = "random", seed: int = 0,
            profile: bool = False) -> dict:
    """Build the model from init_params(cfg, default_rng(seed)), take one
    train step and ``iters`` more (and with ``profile`` one more under
    torch.profiler). Returns the seconds of each step, the losses and gates
    of each, the peak memory and the epochs/day at the steady step time."""
    from ..data.sample import to_device
    from ..train.optim import make_optimizer
    from ..train.step import TrainState, make_train_step
    from ..utils.params import init_params, make_model

    params, state = init_params(cfg, np.random.default_rng(seed))
    model = make_model(cfg, params, state, device)
    opt, sched = make_optimizer(model, cfg, steps_per_epoch=4768)
    ts = TrainState(model, opt, sched)
    step = make_train_step(model)
    one = train_sample(cfg, seed, labels)
    b = to_device({k: np.broadcast_to(np.asarray(v)[None], (batch,)
                                      + np.asarray(v).shape)
                   for k, v in one.items()}, device)
    gates = {}

    def gate_hook(out):
        for k in GATES:
            gates[k] = gates.get(k, 0) + int(out["overflow"][k].sum())

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for _ in range(1 + iters):
        _sync(device)
        t0 = time.perf_counter()
        ts, m = step(ts, b, out_hook=gate_hook)
        _sync(device)
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(m[k]) for k in
                       ("loss", "cls_loss", "box_loss", "mos_loss",
                        "motion_loss")})
    prof = _profiled(lambda: step(ts, b)) if profile else None
    steady = float(np.mean(secs[1:])) if iters else secs[0]
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else None)
    per_day = 86400 / steady * batch / REF_EPOCH_SAMPLES
    return dict(first_s=secs[0], step_s=secs[1:], steady_s=steady,
                losses=losses, gates=gates, peak_gib=peak,
                epochs_per_day=per_day, batch=batch, profile=prof)


def main(argv=None):
    from .. import setup_device
    from ..config import Config
    from . import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--labels", choices=("random", "raycast"),
                    default="random")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step (torch.profiler, the card)")
    ap.add_argument("--out", default=None, help="write the readings here")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    cfg = Config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype=args.dtype))
    r = measure(cfg, device, args.batch, args.iters, args.labels,
                profile=args.profile)
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"device={card} batch={args.batch} dtype={args.dtype}")
    print(f"first step: {r['first_s']:.3f} s, loss={r['losses'][0]['loss']:.4f}")
    print(f"steady step: {r['steady_s']:.3f} s/step (batch {args.batch}); "
          f"steps {[round(s, 3) for s in r['step_s']]}")
    if r["peak_gib"] is not None:
        print(f"peak device memory: {r['peak_gib']:.2f} GiB")
    print(f"gates: {r['gates']}")
    print(f"epochs/day at this step time: {r['epochs_per_day']:.2f} "
          f"(reference schedule: {REF_EPOCHS} epochs)")
    if r["profile"]:
        pr = r["profile"]
        print(f"profiled step: wall {pr['wall_s']:.3f} s, device "
              f"{pr['device_s']:.3f} s, idle share {pr['idle_share']:.3f}, "
              f"{pr['launches']} launches")
        for row in pr["top"]:
            print(f"  {row['ms']:9.2f} ms {row['calls']:6d} x {row['name']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, dtype=args.dtype, **r), fh, indent=1)
    return r


if __name__ == "__main__":
    main()
