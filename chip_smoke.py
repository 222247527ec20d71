#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--details PATH]

Builds the CUDA kernel from insmos_tpu_torch/csrc, holds it against its
plain PyTorch version on every span conv of one full-config
streaming step, streams 12 scans of the HDL-64E raycast fixture through
InferencePipeline.push_scan at the full default Config (ref-exact mode:
full stem every step, window re-rotated per step), checks the outputs and
the overflow gates, and prints a first step time. Any failure raises and
ends the run with a non-zero exit code; the last line of a successful run
is the device JSON. ``--details PATH`` also writes the per-class kernel
times, step times and gates to PATH as JSON.

Needs one CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.metadata
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from insmos_tpu.config import Config
from insmos_tpu.data.hdl64 import _make_world, raycast_scan
from insmos_tpu_torch import kernels, setup_device
from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.sparse import span_conv as SC
from insmos_tpu_torch.utils.params import init_params, make_model

N_SCANS = 12
# |kernel - plain| <= TOL * max(1, max|plain|): both sum the same exact
# float32 products (bf16 operands widen exactly), in another order, over
# up to kx*TC = 1440 terms per group plus the groups and slots
TOL = 5e-4
# one CUDA kernel replaces both TPU kernels; its launches are counted per
# part (every launch runs main windows, those with slots run slots too)
KERNELS = [
    ("span_conv (main windows)", "insmos_tpu/sparse/span_conv.py:1352"),
    ("span_conv (coverage slots)", "insmos_tpu/sparse/span_conv.py:1394"),
]


def make_stream(cfg, n_steps: int, seed: int = 0):
    """The ref-exact stream of bench.make_stream, without jax: a moving ego
    (~11 m/s) turning at 0.01 rad/step raycasts the HDL-64E fixture world;
    each scan is in its sensor frame and each step's transform carries the
    real rotation. Returns (scans (n_i, 4), tfs (4, 4))."""
    rng = np.random.default_rng(seed)
    world = _make_world(rng)
    ego_speed = np.array([1.1, 0.05])
    P = cfg.runtime.max_points_per_scan
    scans, tfs = [], []
    prev_pose = None
    for w in range(n_steps):
        ego = ego_speed * w
        scan, _ = raycast_scan(world, ego, w, rng)
        psi = 0.01 * w
        c, s = np.cos(psi), np.sin(psi)
        pose = np.eye(4)
        pose[:2, :2] = [[c, -s], [s, c]]
        pose[:2, 3] = ego
        scan_f = scan.astype(np.float32).copy()
        scan_f[:, :2] = scan_f[:, :2] @ np.float32([[c, s], [-s, c]]).T
        tf = (np.linalg.inv(pose) @ (prev_pose if prev_pose is not None
                                     else pose)).astype(np.float32)
        prev_pose = pose
        n = min(len(scan_f), P)
        scans.append(scan_f[rng.permutation(len(scan_f))[:n]])
        tfs.append(tf)
    return scans, tfs


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_setup():
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    nvcc_rel = [ln for ln in nvcc.splitlines() if "release" in ln][-1].strip()
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "not installed")
    print(f"versions: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc_rel}, triton {triton}, python {sys.version.split()[0]}")
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    path, build_s, _ = kernels.build()
    kernels.load_library()
    print(f"kernel library built in {build_s:.2f} s (load "
          f"{time.perf_counter() - t0:.2f} s): {path}")
    return card


class Recorder:
    """Records the span_conv_parts calls of one step (inputs and the
    kernel's output) by wrapping the module function."""

    def __init__(self):
        self.calls = []
        self._orig = SC.span_conv_parts

    def __enter__(self):
        def rec(*args):
            out = self._orig(*args)
            self.calls.append((args, out))
            return out

        SC.span_conv_parts = rec
        return self

    def __exit__(self, *exc):
        SC.span_conv_parts = self._orig


def shape_class(args) -> str:
    _, feats, weights, parts, _, _, plan, T_out = args
    k3, s3 = plan.kernel3, plan.stride3
    if k3 == (5, 5, 5):
        name = "stem 5x5x5"
    elif k3 == (2, 2, 2):
        name = "down 2x2x2 s2 +occ"
    elif k3 == (1, 1, 3):
        name = "conv_out 1x1x3 s(1,1,2)"
    elif s3 == (2, 2, 2):
        name = "unet 3x3x3 s2p1"
    elif parts[0].T == 1:
        name = "unet 3x3x3 subm"
    else:
        name = "block 3x3x3x3" + (" cat" if len(parts) > 1 else "")
        if parts[0].t0_off or T_out < parts[0].T:
            name += " t-pruned"
    return f"{name} span{plan.span}"


def cuda_ms(fn, reps: int = 3) -> float:
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


def phase_kernels(cfg, model, scans, tfs):
    """Kernel vs plain on every span conv of one full-window step."""
    pipe = InferencePipeline(cfg, model, "cuda")
    W = cfg.model.n_past_steps
    for s, tf in zip(scans[:W - 1], tfs[:W - 1]):
        pipe.push_scan(s, tf)
    with Recorder() as rec:
        pipe.push_scan(scans[W - 1], tfs[W - 1])
    torch.cuda.synchronize()
    err = {"main": 0.0, "slots": 0.0}
    times = {k: 0.0 for k in ("main", "slots", "main_plain", "slots_plain")}
    classes = {}
    for args, out in rec.calls:
        x_keys, feats_cat, weights, parts, oc, ov, plan, T_out = args
        feats, wg = SC._prepare(feats_cat, weights, parts, plan, T_out)
        main_plan = dataclasses.replace(plan, gs=plan.gs[:, :0])
        core = (x_keys, feats, wg, oc, ov)
        ref = SC.span_conv_core_plain(*core, plan)
        scale = max(1.0, float(ref.abs().max()))
        e_full = float((out - ref).abs().max())
        e_main = float((SC.span_conv_core_cuda(*core, main_plan)
                        - SC.span_conv_core_plain(*core, main_plan)
                        ).abs().max())
        live_slots = int((plan.gs[1] >= 0).sum())
        # the same call with float32 operands
        f32 = (x_keys, feats_cat.float(), [w.float() for w in weights], parts,
               oc, ov, plan, T_out)
        ref32 = SC.span_conv_parts_plain(*f32)
        e32 = float((SC.span_conv_parts(*f32) - ref32).abs().max())
        scale32 = max(1.0, float(ref32.abs().max()))
        cls = shape_class(args)
        if max(e_full, e_main) > TOL * scale or e32 > TOL * scale32:
            raise AssertionError(
                f"kernel disagrees with plain on {cls}: bf16 {e_full:.3g} "
                f"main {e_main:.3g} f32 {e32:.3g} (scale {scale:.3g})")
        err["main"] = max(err["main"], e_main)
        if live_slots:
            err["slots"] = max(err["slots"], e_full)
        t_main = cuda_ms(lambda: SC.span_conv_core_cuda(*core, main_plan))
        t_full = cuda_ms(lambda: SC.span_conv_core_cuda(*core, plan))
        p_main = cuda_ms(lambda: SC.span_conv_core_plain(*core, main_plan), 1)
        p_full = cuda_ms(lambda: SC.span_conv_core_plain(*core, plan), 1)
        times["main"] += t_main
        times["slots"] += max(t_full - t_main, 0.0)
        times["main_plain"] += p_main
        times["slots_plain"] += max(p_full - p_main, 0.0)
        c = classes.setdefault(cls, dict(calls=0, V=0, Vin=0, TC=0, TO=0,
                                         live_slots=0, kernel_ms=0.0,
                                         plain_ms=0.0, max_err=0.0))
        c["calls"] += 1
        c["V"] = max(c["V"], oc.shape[0])
        c["Vin"] = max(c["Vin"], x_keys.shape[0])
        c["TC"] = max(c["TC"], feats.shape[1])
        c["TO"] = max(c["TO"], wg.shape[2])
        c["live_slots"] += live_slots
        c["kernel_ms"] += t_full
        c["plain_ms"] += p_full
        c["max_err"] = max(c["max_err"], e_full, e32)
    need = ["stem 5x5x5", "down 2x2x2 s2 +occ", "cat t-pruned",
            "unet 3x3x3 subm", "unet 3x3x3 s2p1", "conv_out", "span192",
            "span256", "span384"]
    missing = [n for n in need if not any(n in c for c in classes)]
    if missing:
        raise AssertionError(f"shape classes not exercised: {missing}")
    if not any(c["live_slots"] for c in classes.values()):
        raise AssertionError("no recorded conv had live coverage slots")
    torch.cuda.synchronize()
    print(f"kernel vs plain: {len(rec.calls)} span convs of one full-window "
          f"step agree within {TOL} x max(1, |plain|) in bf16 and f32 "
          f"(max abs err main {err['main']:.3g}, with slots {err['slots']:.3g})")
    return err, times, classes


def small_config():
    """A small grid (12.8 m BEV range) for the card-vs-CPU reference run."""
    base = Config()
    mn = dataclasses.replace(base.model.motionnet,
                             crop_range=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.8),
                             site_capacities=(8192, 4096, 2048, 1024))
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)),
        model=dataclasses.replace(
            base.model, n_past_steps=3, max_voxels=4096,
            unet_capacities=(4096, 2048, 1024, 512, 512),
            unet_site_capacity=4096, motionnet=mn),
        runtime=dataclasses.replace(base.runtime, max_points_per_scan=2048,
                                    compute_dtype="float32"),
    )


def phase_reference(device):
    """Small input: the port on the card (kernel) against the port on the
    CPU (plain versions, which the CPU tests hold against the JAX
    package), float32, 3 cropped scans of the same stream."""
    cfg = small_config()
    params, state = init_params(cfg, np.random.default_rng(1))
    scans, tfs = make_stream(Config(), 3, seed=1)
    rng = np.random.default_rng(1)
    crops = []
    for s in scans:
        s = s[(np.abs(s[:, 0]) < 6.6) & (np.abs(s[:, 1]) < 6.6)]
        crops.append(s[rng.permutation(len(s))[:2048]])
    outs = []
    for dev in (device, "cpu"):
        pipe = InferencePipeline(cfg, make_model(cfg, params, state, dev), dev)
        outs.append([pipe.push_scan(s, tf) for s, tf in zip(crops, tfs)])
    err = 0.0
    for g, r in zip(*outs):
        a, b = g["point_logits"].cpu(), r["point_logits"]
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(
                f"card vs CPU point logits differ by {(a - b).abs().max()}")
        if not torch.equal(g["box_mask"].cpu(), r["box_mask"]):
            raise AssertionError("card vs CPU kept-box masks differ")
        err = max(err, float((a - b).abs().max()))
    return err


def phase_main(cfg, model, scans, tfs):
    pipe = InferencePipeline(cfg, model, "cuda")
    W = cfg.model.n_past_steps
    P = cfg.runtime.max_points_per_scan
    SC.SPAN_KERNELS.reset_counts()
    step_ms, gates = [], []
    for i, (s, tf) in enumerate(zip(scans, tfs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.push_scan(s, tf)
        host = InferencePipeline.fetch(out, len(s))
        ovf = {k: v.cpu() for k, v in out["overflow"].items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if out["point_logits"].shape != (P, 3):
            raise AssertionError(f"point_logits shape {out['point_logits'].shape}")
        for k in ("point_logits", "boxes", "scores"):
            if not np.isfinite(host[k]).all():
                raise AssertionError(f"step {i}: non-finite {k}")
        gates.append(dict(
            step=i, window=min(i + 1, W),
            span_overflow=int(ovf["span_overflow"].sum()),
            span_overflow_per_plan=ovf["span_overflow"].tolist(),
            dropped=int(ovf["motion_dropped"].sum() + ovf["unet_dropped"]
                        + ovf["voxelizer_capacity_dropped"]),
            voxelizer_out_of_range=int(ovf["voxelizer_out_of_range"]),
            boxes=len(host["boxes"]),
        ))
    launches = {"main": SC.SPAN_KERNELS.main_launches,
                "slots": SC.SPAN_KERNELS.slot_launches}
    # capacity drops are gated at every step, span overflow on the
    # full-window steps: the reference's plan budgets (kept literally) leave
    # a few uncovered rows on two warm-up windows of this stream, which the
    # plans reproduce to the integer on the CPU
    bad = [g for g in gates if g["dropped"]
           or (g["span_overflow"] and g["window"] == W)]
    if bad:
        raise AssertionError(f"overflow gates not 0: {bad}")
    if not (launches["main"] > 0 and launches["slots"] > 0):
        raise AssertionError(f"kernel launch counters {launches}")
    full = [g["step"] for g in gates if g["window"] == W]
    if len(full) < 3:
        raise AssertionError("fewer than 3 full-window steps")
    warm = {g["step"]: g["span_overflow_per_plan"] for g in gates
            if g["span_overflow"]}
    print(f"main path: {len(scans)} scans at the full default Config "
          f"(W={W}, P={P}); gates 0: dropped at every step, span_overflow at "
          f"every full-window step {full}; warm-up span_overflow per plan "
          f"{warm or 'none'}; voxelizer_out_of_range "
          f"{[g['voxelizer_out_of_range'] for g in gates]}, kept boxes "
          f"{[g['boxes'] for g in gates]}, kernel launches {launches}")
    return step_ms, gates, launches, full


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--details", help="write run details to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    device = setup_device("cuda")
    card = phase_setup()
    cfg = Config()
    params, state = init_params(cfg, np.random.default_rng(0))
    model = make_model(cfg, params, state, device)
    scans, tfs = make_stream(cfg, N_SCANS, seed=0)

    err, times, classes = phase_kernels(cfg, model, scans, tfs)
    ref_err = phase_reference(device)
    print(f"small-input reference: card vs CPU point logits max abs err "
          f"{ref_err:.3g} (tolerance 1e-3)")
    step_ms, gates, launches, full = phase_main(cfg, model, scans, tfs)

    med = statistics.median(step_ms[i] for i in full)
    print(f"step time (first reading, not a benchmark): median {med:.1f} ms "
          f"over the {len(full)} full-window steps = {1e3 / med:.2f} scans/s "
          f"on {card}; all steps ms {[round(t, 1) for t in step_ms]}")
    report = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "insmos_tpu_torch/csrc/span_conv.cu", "replaces": rep,
         "launches": launches[key], "max_abs_err": err[key],
         "ms": times[key], "plain_ms": times[key + "_plain"]}
        for (name, rep), key in zip(KERNELS, ("main", "slots"))
    ]}
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as fh:
            json.dump(dict(card=card, report=report, classes=classes,
                           step_ms=step_ms, gates=gates, ref_err=ref_err), fh,
                      indent=1)
    for name, c in sorted(classes.items()):
        print(f"  class {name}: {json.dumps(c)}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
