#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--details PATH]

Builds the CUDA kernels from insmos_tpu_torch/csrc, holds the span-conv
kernels (bf16 on the tensor cores, the main path; float32 on the CUDA
cores) against their plain PyTorch version on every span conv of one
full-config streaming step and prints each shape class's kernel time
beside its bound (SC.span_conv_work), streams 12 scans of the HDL-64E
raycast fixture through InferencePipeline.push_scan at the full default
Config (ref-exact mode: full stem every step, window re-rotated per step),
checks the outputs and the overflow gates, and prints a first step time;
then streams them again with every span plan, replayed from its CUDA
graph, held against the eager plan field for field, and prints the
graphs captured and replayed.
The incremental phase does the same for the fixed-frame incremental mode
(the JAX package's bench headline: the fixed-frame stream, the window's
site set and stem outputs carried across steps, the stem at T=1 on the new
scan), with the kernels held against plain on every span conv of one of its
full-window steps and its point logits against the direct pipeline's on
the same stream. The CLI phase runs the inference CLIs through their
entry points: predict_mos on two KITTI-format sequences of the fixture
(ref-exact, and --fixed-frame) at the full default Config, in bf16 and
float32, with the gates, the span-conv launches and scans/s, each step
held against the committed JAX record
(tests/torch_goldens/stream_record.npz, tools/stream_record.py), the
float32 runs repeated bit for bit; then both sequences again on the
calibrated weights (tools/stream_record.calibrated_params: BN statistics
from data, so the heatmap follows the scan and a few dozen boxes are
kept), held against the calibrated JAX record (kept boxes one to one
above a score margin, logits inside them); then refine, and evaluate_mos
on a synthetic sequence. The overflow phase holds the kernels against
their plain version on every span conv whose plan leaves rows uncovered
on seed 0's streams (warm-up steps, ref-exact steps 15-19), and their
sums against the JAX kernel's record (tests/torch_overflow_record.py).
The pod phase runs multi-stream inference
(PodInferencePipeline: one step vmapped over the slots, one span-kernel
launch a conv for all slots; 2 slots on two streams of each mode, bf16 and
float32) against single-stream pipelines, with the gates (the span
overflow per plan at the JAX package's own plans on the same streams,
tests/torch_goldens/plan_record.json, tests/torch_plan_record.py), an idle
slot and a rejected rotation, holds the batched kernel against its plain
version and against one launch a slot on every conv of a pod step, reads
the aggregate scans/s at S = 1, 2, 4, 8 beside the single-stream step,
holds ``predict_mos --pod`` against the serial CLI, and runs the pod in
float32 on the calibrated weights. Then it runs
the
span-conv design probes (insmos_tpu_torch.tools.probe_extract, with and
without --production, and probe_dotshapes) at their full case lists, each
kernel held against its plain version, and last the micro probes (T1-T9:
micro_pallas, micro_pallas2, micro_lanegather, micro_lanegather2,
probe_tala) and the rowconv probe (T11: probe_pallas_rowconv) at the TPU
probes' full sizes. The training phase last: full-width train steps (the
windowed engine and its custom backward, train-mode BatchNorm, the losses
and one Adam update), one float32 step held against the committed JAX
record (tests/torch_goldens/train_record.npz, tools/train_record.py) and
repeated, and the training CLI with its resume and a validation pass on
the span kernels; then the training CLI under torchrun (NCCL, world 1)
against two plain runs. Any failure raises and ends the run with a non-zero
exit code; the line before the last lists every kernel with its launches,
error, time (CUDA events; on the probes also torch.profiler's device
time), plain time, bound and one-call PyTorch time, the last line
is the device JSON. ``--details PATH`` also writes the per-class kernel
times, step times, gates and probe readings to PATH as JSON.

Needs one CUDA device; imports no jax and nothing of the JAX package
``insmos_tpu`` (the port keeps its own Config and HDL-64E fixture).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.metadata
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from insmos_tpu_torch import kernels, obs, setup_device, tools
from insmos_tpu_torch.cli import evaluate_mos, predict_mos, refine
from insmos_tpu_torch.cli import train as train_cli
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.kitti import load_files, read_point_cloud
from insmos_tpu_torch.data.synthetic import write_synthetic_sequence
from insmos_tpu_torch.data.hdl64 import make_fixed_frame_stream, make_stream
from insmos_tpu_torch.pipeline import InferencePipeline, PodInferencePipeline
from insmos_tpu_torch.sparse import slab as S
from insmos_tpu_torch.sparse import span_conv as SC
from insmos_tpu_torch.sparse.tensor import KEY_SENTINEL
from insmos_tpu_torch.tools import card_line, cuda_ms
from insmos_tpu_torch.tools import micro_kernels as MK
from insmos_tpu_torch.tools import micro_lanegather as MLG
from insmos_tpu_torch.tools import micro_lanegather2 as MLG2
from insmos_tpu_torch.tools import micro_pallas as MP
from insmos_tpu_torch.tools import micro_pallas2 as MP2
from insmos_tpu_torch.tools import probe_dotshapes as PD
from insmos_tpu_torch.tools import probe_extract as PE
from insmos_tpu_torch.tools import probe_pallas_rowconv as RC
from insmos_tpu_torch.tools import probe_tala as PT
from insmos_tpu_torch.tools import measure_train_step as MT
from insmos_tpu_torch.tools import overflow_plans as OP
from insmos_tpu_torch.tools import stream_record as SR
from insmos_tpu_torch.tools import train_record as TR
from insmos_tpu_torch.utils.checkpoint import (load_checkpoint,
                                               save_checkpoint_from_trees)
from insmos_tpu_torch.utils.params import init_params, make_model

N_SCANS = 12
# |kernel - plain| <= TOL * max(1, max|plain|): both sum the same exact
# float32 products (bf16 operands widen exactly), in another order, over
# up to kx*TC = 1440 terms per group (bf16: per group on the tensor cores)
# plus the groups and slots
TOL = 5e-4
# Incremental vs direct pipeline point logits in bf16 on the card. Where
# both see the same window site set they sum the same products in another
# order only in the stem (T=1 on the scan slab vs T=W on the window); its
# float32 outputs are rounded to bf16 at down1's input, so a last-bit
# change can flip a bf16 rounding that travels through ~40 bf16 convs.
# INC_TOL holds them on the stream with its points moved to voxel centres
# and cut to the MotionNet crop, where the two site sets are equal at every
# step (first reading: equal logits at all 12 steps, max abs err 0). On
# the stream itself the site sets differ, as in the reference: the
# maintained set keeps only sites that were inside the crop, so window
# points that enter the crop across its edge as the ego moves are missing
# from it (up to ~800 of ~255k sites a step on this stream), and the
# direct pipeline's float32 translation moves a few boundary points into
# neighbouring voxels; the logits then differ by up to 0.153, at up to 2%
# of a scan's points (first reading, NVIDIA H100 80GB HBM3, 700 W).
# INC_TOL_STREAM bounds the largest difference there and INC_SHARE_STREAM
# the share of points beyond 1e-3.
INC_TOL = 5e-3
# the float32 kernel's output sum on an overflowing warm-up plan against
# the overflow record's (the JAX kernel's on the CPU), as a share of the
# record's sum of |out|: the CPU comparison's float32 tolerance
# (tests/torch_overflow_record.TOL); the card's inputs come from its own
# float32 run of the steps before
OVERFLOW_SUM_TOL = 1e-4
INC_TOL_STREAM = 0.25
INC_SHARE_STREAM = 0.05
# span-conv launches a step of the main path in both modes (MotionNet and
# UNet: every subm and strided sparse conv)
SPAN_CONVS_PER_STEP = 46
# timed full-width train steps after the warm one (phase_train)
TRAIN_STEPS = 3
# multi-stream (pod) inference: slot counts of the first scans/s reading,
# and its warm-up and timed steps
POD_SLOTS = (1, 2, 4, 8)
POD_WARM = POD_TIMED = 10
# the JAX package's span_overflow per plan on phase_pod's streams, by
# "<mode>/<seed>" and step (tests/torch_plan_record.py)
PLAN_RECORD = os.path.join("tests", "torch_goldens", "plan_record.json")
OUT_KEYS = ("point_logits", "boxes", "scores", "labels", "box_mask")
# the data-parallel training runs: every run in torch's deterministic mode
# (the windowed engine's index_add_ then sums in a fixed order; cuBLAS
# needs the workspace setting), the training CLI run as __main__
DP_PRELUDE = ("import runpy, torch; torch.use_deterministic_algorithms(True);"
              " runpy.run_module('insmos_tpu_torch.cli.train', "
              "run_name='__main__', alter_sys=True)")
# the micro probes (T1-T9) and the rowconv probe (T11), in the order of
# their TPU kernels
MICRO_PROBES = (MP, MP2, MLG, MLG2, PT, RC)
# one CUDA kernel replaces both TPU kernels; its launches are counted per
# part (every launch runs main windows, those with slots run slots too)
KERNELS = [
    ("span_conv (main windows)", "insmos_tpu/sparse/span_conv.py:1352"),
    ("span_conv (coverage slots)", "insmos_tpu/sparse/span_conv.py:1394"),
]


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


class PlanCheck:
    """Holds every span plan that a CUDA graph replays
    (``SC.PlanGraphs.replay``) against the eager builder on the same
    inputs, field for field; ``calls`` counts the replays held and
    ``checked`` the plans they built."""

    def __enter__(self):
        self.calls = self.checked = 0
        self._orig = orig = SC.PlanGraphs.replay

        def held(graphs, x_keys, requests):
            got = orig(graphs, x_keys, requests)
            self.calls += 1
            for g, w in zip(got, SC._make_span_plans(x_keys, requests),
                            strict=True):
                self._same(g, w)
            return got

        SC.PlanGraphs.replay = held
        return self

    def __exit__(self, *exc):
        SC.PlanGraphs.replay = self._orig

    def _same(self, got, want):
        for f in dataclasses.fields(SC.SpanPlan):
            a, b = getattr(got, f.name), getattr(want, f.name)
            same = (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b)) if isinstance(a, torch.Tensor) \
                else a == b
            if not same:
                raise AssertionError(f"graphed plan {got.kernel3} differs "
                                     f"from the eager one in {f.name}")
        self.checked += 1


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


def total_bound(parts):
    """(sum of bound_ms, what sets most of it) over readings that each
    carry bound_ms and bound_by."""
    by = {"bytes": 0.0, "operations": 0.0}
    for p in parts:
        by[p["bound_by"]] += p["bound_ms"]
    return sum(by.values()), max(by, key=by.get)


# the shape classes each mode's step must exercise
NEED_CLASSES = {
    "ref-exact": ["stem 5x5x5", "down 2x2x2 s2 +occ", "cat t-pruned",
                  "unet 3x3x3 subm", "unet 3x3x3 s2p1", "conv_out",
                  "span192", "span256", "span384"],
    "incremental": ["stem 5x5x5 span192", "down 2x2x2 s2 +occ",
                    "cat t-pruned", "unet 3x3x3 subm", "unet 3x3x3 s2p1",
                    "conv_out", "span256", "span384"],
}


def phase_kernels(cfg, model, scans, tfs, mode="ref-exact"):
    """Kernel vs plain on every span conv of one full-window step of the
    pipeline in ``mode`` (as ``cfg`` selects), with the bound of each
    (SC.span_conv_work on its bf16 operands)."""
    pipe = InferencePipeline(cfg, model, "cuda")
    W = cfg.model.n_past_steps
    for s, tf in zip(scans[:W - 1], tfs[:W - 1]):
        pipe.push_scan(s, tf)
    with Recorder() as rec:
        pipe.push_scan(scans[W - 1], tfs[W - 1])
    torch.cuda.synchronize()
    err = {"main": 0.0, "slots": 0.0}
    times = {k: 0.0 for k in ("main", "slots", "main_plain", "slots_plain")}
    bounds = {"main": [], "slots": []}
    rel = 0.0
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
        rel = max(rel, e_full / scale, e_main / scale)
        if live_slots:
            err["slots"] = max(err["slots"], e_full)
        w_main = SC.span_conv_work(*core, main_plan)
        w_full = SC.span_conv_work(*core, plan)
        bounds["main"].append(w_main)
        bounds["slots"].append(kernels.bound(0, w_full["flops"]
                                             - w_main["flops"]))
        t_main = cuda_ms(lambda: SC.span_conv_core_cuda(*core, main_plan))
        t_full = cuda_ms(lambda: SC.span_conv_core_cuda(*core, plan))
        # the same conv on the CUDA cores with float32 operands, and the
        # host time of the bf16 kernel's weight re-layout
        core32 = (x_keys, *SC._prepare(*f32[1:4], plan, T_out), oc, ov)
        t_f32 = cuda_ms(lambda: SC.span_conv_core_cuda(*core32, plan))
        h0 = time.perf_counter()
        for _ in range(20):
            SC.mma_layout(wg)
        layout_us = (time.perf_counter() - h0) / 20 * 1e6
        p_main = cuda_ms(lambda: SC.span_conv_core_plain(*core, main_plan), 1)
        p_full = cuda_ms(lambda: SC.span_conv_core_plain(*core, plan), 1)
        times["main"] += t_main
        times["slots"] += max(t_full - t_main, 0.0)
        times["main_plain"] += p_main
        times["slots_plain"] += max(p_full - p_main, 0.0)
        c = classes.setdefault(cls, dict(calls=0, V=0, Vin=0, TC=0, TO=0,
                                         live_slots=0, kernel_ms=0.0,
                                         plain_ms=0.0, bound_ms=0.0,
                                         bound_ops_ms=0.0, max_err=0.0,
                                         matched=0, useful_tflop=0.0,
                                         f32_kernel_ms=0.0,
                                         layout_host_us=0.0))
        c["calls"] += 1
        c["bound_ms"] += w_full["bound_ms"]
        if w_full["bound_by"] == "operations":
            c["bound_ops_ms"] += w_full["bound_ms"]
        c["matched"] += w_full["matched"]
        c["useful_tflop"] += w_full["flops"] / 1e12
        c["f32_kernel_ms"] += t_f32
        c["layout_host_us"] += layout_us
        c["V"] = max(c["V"], oc.shape[0])
        c["Vin"] = max(c["Vin"], x_keys.shape[0])
        c["TC"] = max(c["TC"], feats.shape[1])
        c["TO"] = max(c["TO"], wg.shape[2])
        c["live_slots"] += live_slots
        c["kernel_ms"] += t_full
        c["plain_ms"] += p_full
        c["max_err"] = max(c["max_err"], e_full, e32)
    missing = [n for n in NEED_CLASSES[mode]
               if not any(n in c for c in classes)]
    if missing:
        raise AssertionError(f"shape classes not exercised: {missing}")
    if not any(c["live_slots"] for c in classes.values()):
        raise AssertionError("no recorded conv had live coverage slots")
    torch.cuda.synchronize()
    for c in classes.values():
        c["bound_by"] = ("operations" if c.pop("bound_ops_ms")
                         > c["bound_ms"] / 2 else "bytes")
        c["share_of_bound"] = c["bound_ms"] / c["kernel_ms"]
    print(f"kernel vs plain ({mode}): {len(rec.calls)} span convs of one "
          f"full-window step agree within {TOL} x max(1, |plain|) in bf16 and f32 "
          f"(max abs err main {err['main']:.3g}, with slots {err['slots']:.3g};"
          f" bf16 max abs err / max(1, |plain|) {rel:.3g})")
    return err, times, classes, {k: total_bound(v) for k, v in bounds.items()}


def incremental_config(cfg):
    """``cfg`` in the fixed-frame incremental mode."""
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, incremental_stem=True))


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


def phase_reference(device, incremental=False):
    """Small input: the port on the card (kernel) against the port on the
    CPU (plain versions, which the CPU tests hold against the JAX
    package), float32, cropped scans of the same stream: 3 of the
    ref-exact stream or, ``incremental``, 4 of the fixed-frame stream (the
    window of 3 rolls once) through the incremental pipeline."""
    cfg = small_config()
    params, state = init_params(cfg, np.random.default_rng(1))
    if incremental:
        mn = dataclasses.replace(cfg.model.motionnet, stem_scan_capacity=2048)
        cfg = incremental_config(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, motionnet=mn)))
        scans, tfs, _ = make_fixed_frame_stream(Config(), 4, seed=1)
    else:
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
        if pipe.n_full_steps:
            raise AssertionError(f"{pipe.n_full_steps} recovery steps")
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


def step_gates(i, W, out):
    """The overflow gates and the kept-box count of step ``i`` of a
    streamed run of window ``W`` from its outputs ``out``."""
    ovf = {k: v.cpu() for k, v in out["overflow"].items()}
    return dict(
        step=i, window=min(i + 1, W),
        span_overflow=int(ovf["span_overflow"].sum()),
        span_overflow_per_plan=ovf["span_overflow"].tolist(),
        dropped=int(ovf["motion_dropped"].sum() + ovf["unet_dropped"]
                    + ovf["voxelizer_capacity_dropped"]),
        voxelizer_out_of_range=int(ovf["voxelizer_out_of_range"]),
        boxes=int(out["box_mask"].sum()))


def stream_gated(pipe, scans, tfs):
    """Streams the scans through ``pipe``, checking each step's outputs.
    Returns (step ms, per-step gates)."""
    W = pipe.cfg.model.n_past_steps
    P = pipe.cfg.runtime.max_points_per_scan
    step_ms, gates = [], []
    for i, (s, tf) in enumerate(zip(scans, tfs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.push_scan(s, tf)
        host = InferencePipeline.fetch(out, len(s))
        gates.append(step_gates(i, W, out))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if out["point_logits"].shape != (P, 3):
            raise AssertionError(f"point_logits shape {out['point_logits'].shape}")
        for k in ("point_logits", "boxes", "scores"):
            if not np.isfinite(host[k]).all():
                raise AssertionError(f"step {i}: non-finite {k}")
    return step_ms, gates


def span_launches(before) -> dict:
    """The span-kernel launches since the counter snapshot ``before``
    (``obs.counters()``): all of them, and those that ran coverage
    slots."""
    moved = obs.since(before)
    return {"main": moved["span_conv.launches"],
            "slots": moved["span_conv.slot_launches"]}


def check_gates(gates, launches, W):
    """The overflow gates and the launch counts of one streamed run.
    Returns the full-window steps and the warm-up span overflow per plan."""
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
    return full, warm


def phase_main(cfg, model, scans, tfs):
    pipe = InferencePipeline(cfg, model, "cuda")
    W = cfg.model.n_past_steps
    P = cfg.runtime.max_points_per_scan
    c0 = obs.counters()
    step_ms, gates = stream_gated(pipe, scans, tfs)
    launches = span_launches(c0)
    full, warm = check_gates(gates, launches, W)
    print(f"main path: {len(scans)} scans at the full default Config "
          f"(W={W}, P={P}); gates 0: dropped at every step, span_overflow at "
          f"every full-window step {full}; warm-up span_overflow per plan "
          f"{warm or 'none'}; voxelizer_out_of_range "
          f"{[g['voxelizer_out_of_range'] for g in gates]}, kept boxes "
          f"{[g['boxes'] for g in gates]}, kernel launches {launches}")
    moved = obs.since(c0)
    plans = {k: moved["plan." + k] for k in ("builds", "replays", "captures")}
    if not (plans["replays"] == plans["builds"] > 0
            and plans["captures"] == len(pipe.plan_graphs)):
        raise AssertionError(f"plan graphs: {plans}, "
                             f"{len(pipe.plan_graphs)} graphs")
    # the same stream again, every graphed plan held against the eager one
    c1 = obs.counters()
    with PlanCheck() as check:
        stream_gated(InferencePipeline(cfg, model, "cuda"), scans, tfs)
    if check.calls != obs.since(c1)["plan.builds"]:
        raise AssertionError(f"{check.calls} graphed plan builds of "
                             f"{obs.since(c1)['plan.builds']}")
    print(f"plan graphs: {plans['captures']} captured, {plans['replays']} "
          f"replays of {plans['builds']} plan builds over {len(scans)} "
          f"steps; a second stream's {check.checked} graphed plans equal "
          f"the eager ones field for field")
    return step_ms, gates, launches, full


def phase_incremental(cfg, model):
    """The fixed-frame incremental mode at ``cfg`` (the JAX package's bench
    headline): kernel vs plain on every span conv of one full-window step,
    then the fixed-frame stream through InferencePipeline.push_scan with
    the launch counts read just before and just after, the gates of the
    main path and no recovery step, then the direct pipeline on the
    same stream and on its points moved to voxel centres inside the
    MotionNet crop, stepped beside
    the incremental one (``versus_direct``): point logits within
    INC_TOL_STREAM (INC_SHARE_STREAM of the points beyond 1e-3) on the
    stream, and equal window site sets and logits within INC_TOL on the
    voxel centres."""
    icfg = incremental_config(cfg)
    W = icfg.model.n_past_steps
    scans, tfs, shifts = make_fixed_frame_stream(icfg, N_SCANS, seed=0)
    err, _, classes, _ = phase_kernels(icfg, model, scans, tfs,
                                       "incremental")
    pipe = InferencePipeline(icfg, model, "cuda")
    c0 = obs.counters()
    step_ms, gates = stream_gated(pipe, scans, tfs)
    launches = span_launches(c0)
    if pipe.n_full_steps:
        raise AssertionError(f"{pipe.n_full_steps} recovery steps on the "
                             "fixed-frame stream")
    full, warm = check_gates(gates, launches, W)
    print(f"incremental path: {len(scans)} scans of the fixed-frame stream "
          f"at the full default Config (W={W}, cache shifts "
          f"{[s.tolist() for s in shifts]}), n_full_steps 0; gates 0: "
          f"dropped at every step, span_overflow at every full-window step "
          f"{full}; warm-up span_overflow per plan {warm or 'none'}; "
          f"kernel launches {launches}")
    crop = np.float32(icfg.model.motionnet.crop_range)
    lo, hi = crop[:3], crop[3:]
    centred = []
    for sc in scans:
        c = sc.copy()
        c[:, :3] = lo + (np.floor((sc[:, :3] - lo) * np.float32(10.0))
                         + np.float32(0.5)) / np.float32(10.0)
        centred.append(c[((c[:, :3] >= lo) & (c[:, :3] < hi)).all(axis=1)])
    vs_direct = {}
    for name, stream in (("stream", scans), ("voxel centres", centred)):
        rows = vs_direct[name] = versus_direct(icfg, cfg, model, stream, tfs)
        worst = max(r["max_abs_err"] for r in rows)
        share = max(r["points_over_1e_3"] / r["points"] for r in rows)
        moved = [r["sites_only_direct"] + r["sites_only_incremental"]
                 for r in rows]
        print(f"incremental vs direct pipeline, bf16, {name}: point logits "
              f"max abs err {worst:.3g}, per step "
              f"{[round(r['max_abs_err'], 5) for r in rows]}; points over "
              f"1e-3 {[r['points_over_1e_3'] for r in rows]}; window sites "
              f"in one set only {moved}")
        if name == "stream":
            if worst > INC_TOL_STREAM or share > INC_SHARE_STREAM:
                raise AssertionError(
                    f"incremental vs direct on the stream: max abs err "
                    f"{worst} (bound {INC_TOL_STREAM}), share of points over "
                    f"1e-3 {share} (bound {INC_SHARE_STREAM})")
        elif any(moved) or worst > INC_TOL:
            raise AssertionError(
                f"incremental vs direct at voxel centres: window sites in one "
                f"set only {moved}, max abs err {worst} (tolerance "
                f"{INC_TOL})")
    return dict(step_ms=step_ms, gates=gates, launches=launches, full=full,
                kernel_err=err, classes=classes, vs_direct=vs_direct)


def window_keys(pipe):
    """The sorted L1 site keys that the direct pipeline's last step built
    from its window's points (as motionnet_forward builds them)."""
    mc = pipe.cfg.model.motionnet
    pts, num = pipe._buf["points"], pipe._buf["num_points"]
    W, P = pts.shape[:2]
    lo = torch.tensor(mc.crop_range[:3], dtype=pts.dtype, device=pts.device)
    valid = ((torch.arange(P, device=pts.device)[None] < num[:, None])
             & pipe._buf["scan_mask"][:, None])
    c3 = torch.floor((pts[..., :3].reshape(-1, 3) - lo) * 10.0).to(
        torch.int32)
    tcol = torch.arange(W, dtype=torch.int32, device=pts.device)[:, None]
    slab, _, _, _ = S.build_slab(c3, tcol.expand(W, P).reshape(-1),
                                 valid.reshape(-1), mc.grid_size, W,
                                 mc.site_capacities[0])
    return slab.keys[slab.valid]


def versus_direct(icfg, cfg, model, scans, tfs):
    """The incremental and the direct pipeline stepped together over the
    same scans: per step the point logits' difference and the window sites
    that only one of the two site sets holds."""
    inc = InferencePipeline(icfg, model, "cuda")
    direct = InferencePipeline(cfg, model, "cuda")
    rows = []
    for s, tf in zip(scans, tfs):
        a = inc.push_scan(s, tf)["point_logits"][:len(s)]
        b = direct.push_scan(s, tf)["point_logits"][:len(s)]
        kd = window_keys(direct)
        ki = inc._buf["win"]["keys"]
        ki = ki[ki != KEY_SENTINEL]
        e = (a - b).abs()
        rows.append(dict(
            max_abs_err=float(e.max()), points=len(s),
            points_over_1e_3=int((e > 1e-3).sum()),
            sites_only_direct=int((~torch.isin(kd, ki)).sum()),
            sites_only_incremental=int((~torch.isin(ki, kd)).sum())))
    if inc.n_full_steps:
        raise AssertionError(f"{inc.n_full_steps} recovery steps")
    return rows


def cli_run(ckpt, root, out, seq, fixed, maps=None):
    """One predict_mos run through its entry point, on the card, over one
    sequence. Returns (its stats, the captured steps' outputs; with
    ``maps``, SR.capturing's, the head's maps and the scans too)."""
    argv = ["--ckpt", ckpt, "--data_path", root, "--sequences", str(seq),
            "--out", out] + (["--fixed-frame"] if fixed else [])
    with SR.capturing(predict_mos, maps) as steps:
        stats = predict_mos.main(argv)
    return stats, steps


def check_artifacts(root, pred_root, seq, refined=None):
    """Every scan of the sequence has its three artifacts in the
    reference's formats (and, with ``refined``, its refined labels)."""
    ss = f"{seq:02d}"
    sub = os.path.join("sequences", ss, "predictions")
    scans = load_files(os.path.join(root, ss, "velodyne"))
    for i, f in enumerate(scans):
        n = len(read_point_cloud(f))
        name = f"{i:06d}"
        lab = np.fromfile(os.path.join(pred_root, "mos_preb", sub,
                                       name + ".label"), np.int32)
        conf = np.load(os.path.join(pred_root, "confidence", sub,
                                    name + ".npy"))
        box = np.load(os.path.join(pred_root, "bbox_preb", sub, name + ".npy"),
                      allow_pickle=True).item()
        ok = (len(lab) == n and set(np.unique(lab).tolist()) <= {0, 9, 251}
              and conf.dtype == np.float64 and conf.shape == (n, 2)
              and bool(np.isfinite(conf).all())
              and sorted(box) == ["pred_boxes", "pred_labels", "pred_scores"]
              and box["pred_boxes"].dtype == np.float32
              and box["pred_boxes"].shape[1:] == (7,)
              and box["pred_scores"].dtype == np.float32
              and box["pred_labels"].dtype == np.int64)
        if refined is not None:
            r = np.fromfile(os.path.join(refined, "mos_preb", sub,
                                         name + ".label"), np.int32)
            ok = ok and len(r) == n and set(np.unique(r).tolist()) <= {
                0, 9, 251}
        if not ok:
            raise AssertionError(f"sequence {ss} scan {name}: artifacts not "
                                 "in the reference's formats")
    return len(scans)


def phase_cli(card):
    """The inference CLIs through their entry points on the card.

    1. The main path of this slice: both fixture sequences (ref-exact, and
       the straight-ego stream that ``--fixed-frame`` frames itself) at the
       full default Config, written through the port's own code, a port
       checkpoint of the JAX record's numpy weights, ``predict_mos`` on
       each in bf16 (the default) and in float32, with the span-kernel
       launch counts read just before each run and just after:
       gates of the main path, no recovery step on the fixed-frame stream,
       46 span-conv launches a step, the artifacts in the reference's
       formats, scans/s per sequence; every step held against the
       committed JAX record (``tools/stream_record.py``) within
       ``stream_record.TOLERANCES``, every counter equal. The float32 run
       of each sequence is made twice and must repeat bit for bit.
       Then the same runs on the calibrated weights against the
       calibrated record (:func:`cli_calibrated`).
    2. ``refine`` over what the bf16 runs wrote.
    3. ``predict_mos``, ``refine`` and ``evaluate_mos`` on a synthetic
       sequence with labels.
    Any failed comparison raises after the readings are printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase_cli_", dir=os.path.join(here, "runs"))
    failures = []
    try:
        rcfg, meta, record = SR.load_record(os.path.join(here, SR.RECORD))
        cfg = Config()
        if dataclasses.replace(rcfg, runtime=dataclasses.replace(
                rcfg.runtime, compute_dtype=cfg.runtime.compute_dtype)) != cfg:
            raise AssertionError("the JAX record is not at the full default "
                                 "Config")
        W = cfg.model.n_past_steps
        root = os.path.join(work, "kitti")
        SR.write_sequences(root, cfg, meta["n_scans"], meta["seed"])
        params, state = init_params(cfg, np.random.default_rng(0))
        parity, runs, repeat = {}, {}, {}
        launches = {"main": 0, "slots": 0}
        for route in ("bfloat16", "float32"):
            cfg_r = dataclasses.replace(cfg, runtime=dataclasses.replace(
                cfg.runtime, compute_dtype=route))
            ckpt = os.path.join(work, f"ckpt_{route}")
            save_checkpoint_from_trees(ckpt, cfg_r, params, state)
            out = os.path.join(work, f"preb_{route}")
            pred_root = os.path.join(out, cfg_r.experiment_id)
            for name, (seq, fixed) in SR.SEQUENCES.items():
                key = f"{route} {name}"
                c0 = obs.counters()
                stats, steps = cli_run(ckpt, root, out, seq, fixed)
                n_launch, n_slot = span_launches(c0).values()
                if route == cfg.runtime.compute_dtype:
                    launches["main"] += n_launch
                    launches["slots"] += n_slot
                per = stats["per_sequence"][0]
                gates = [step_gates(i, W, o) for i, (o, _) in enumerate(steps)]
                rows = SR.summarize(steps, pred_root, seq)
                del steps
                runs[key] = dict(scans=per["scans"], seconds=per["seconds"],
                                 scans_per_s=per["scans"] / per["seconds"],
                                 n_full_steps=per["n_full_steps"],
                                 gates=gates, launches=n_launch)
                try:
                    full, warm = check_gates(
                        gates, {"main": n_launch, "slots": n_slot}, W)
                except AssertionError as e:
                    failures.append(f"{key}: {e}")
                    full, warm = [], {}
                if n_launch != SPAN_CONVS_PER_STEP * len(rows):
                    failures.append(f"{key}: {n_launch} span-conv launches "
                                    f"over {len(rows)} steps")
                if per["n_full_steps"]:
                    failures.append(f"{key}: {per['n_full_steps']} recovery "
                                    "steps")
                check_artifacts(root, pred_root, seq)
                res = SR.compare(record[name], rows, W, route)
                parity[key] = res
                failures += [f"{key}: {f}" for f in res["failures"]]
                print(f"cli, full default Config, {key}: {per['scans']} scans "
                      f"in {per['seconds']:.2f} s = "
                      f"{runs[key]['scans_per_s']:.3f} scans/s on {card} (the "
                      f"CLI's own clock: scan reads, steps, artifact writes); "
                      f"gates 0 at every step (dropped) and full-window step "
                      f"{full} (span_overflow); warm-up span_overflow per "
                      f"plan {warm or 'none'}; n_full_steps "
                      f"{per['n_full_steps']}; span-conv launches {n_launch}")
                print(f"  vs the JAX record: {res['compared']} of {len(rows)} "
                      f"steps compared, point logits max abs err "
                      f"{res['max_abs']:.3g}, share over 1e-3 "
                      f"{res['share_over_1e_3']:.3g}, kept boxes "
                      f"{[s.get('boxes_got') for s in res['steps']]}, of the "
                      f"record's unmatched "
                      f"{[s.get('boxes_unmatched') for s in res['steps']]} "
                      f"(matched max abs {res['box_abs']:.3g}), label count "
                      f"changes {[s.get('count_diff') for s in res['steps']]},"
                      f" counters equal "
                      f"{all(s.get('counters_equal', True) for s in res['steps'])}"
                      f", tolerances {SR.TOLERANCES[route]}; "
                      f"{len(res['failures'])} failures")
                if route == "float32":
                    _, again = cli_run(ckpt, root, out, seq, fixed)
                    rows2 = SR.summarize(again, pred_root, seq)
                    del again
                    same = all(np.array_equal(a[k], b[k]) for a, b in zip(
                        rows, rows2) for k in a)
                    repeat[name] = same
                    if not same:
                        failures.append(f"{key}: a second run differs")
                    print(f"  float32 run repeated: equal bit for bit {same}")

        # 1b. the calibrated record: the detection branch decided by the
        # scan, both routes against its JAX record
        calibrated = cli_calibrated(card, cfg, work, root, failures)

        # 2. refine over the main path's output
        pred_root = os.path.join(work, f"preb_{cfg.runtime.compute_dtype}",
                                 cfg.experiment_id)
        refined = os.path.join(work, "preb_refine")
        refine.main(["--data_path", root, "--pred", pred_root, "--out",
                     refined, "--sequences"] + [str(q) for q, _ in
                                                SR.SEQUENCES.values()])
        for seq, _ in SR.SEQUENCES.values():
            check_artifacts(root, pred_root, seq, refined)

        # 3. evaluate_mos on a sequence with labels
        ckpt = os.path.join(work, f"ckpt_{cfg.runtime.compute_dtype}")
        syn = os.path.join(work, "synthetic")
        write_synthetic_sequence(syn, seq=8, n_scans=14, seed=0)
        syn_out = os.path.join(work, "preb_syn")
        cli_run(ckpt, syn, syn_out, 8, False)
        syn_pred = os.path.join(syn_out, cfg.experiment_id)
        syn_ref = os.path.join(work, "preb_syn_refine")
        refine.main(["--data_path", syn, "--pred", syn_pred, "--out", syn_ref,
                     "--sequences", "8"])
        n_syn = check_artifacts(syn, syn_pred, 8, syn_ref)
        ious = {k: evaluate_mos.evaluate(syn, os.path.join(p, "mos_preb"), [8])
                for k, p in (("predict", syn_pred), ("refine", syn_ref))}
        if not all(0.0 <= v <= 1.0 for r in ious.values() for v in r.values()):
            failures.append(f"evaluate_mos: {ious}")
        n_main = sum(r["scans"] for k, r in runs.items()
                     if k.startswith(cfg.runtime.compute_dtype))
        print(f"cli: refine rewrote {n_main} full-config scans and {n_syn} "
              f"synthetic scans; evaluate_mos on the synthetic sequence "
              f"(random weights): {ious}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("phase_cli: " + " | ".join(failures))
    return dict(parity=parity, runs=runs, repeat=repeat, launches=launches,
                evaluate=ious, calibrated=calibrated)


def fmt(v) -> str:
    """A reading for a line of output: floats to 3 figures."""
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(fmt(x) for x in v) + "]"
    return f"{v:.3g}" if isinstance(v, float) else str(v)


def cli_calibrated(card, cfg, work, root, failures):
    """phase_cli's second record: ``predict_mos`` on both sequences, in
    bf16 and float32, from a port checkpoint of the calibrated weights
    (``stream_record.calibrated_params``: BN statistics set from data, the
    class head's bias and scale), each step held against the calibrated
    JAX record (``stream_record.compare_calibrated``,
    TOLERANCES_CALIBRATED): kept boxes one to one above the margin, the
    logits at the seeded and the in-box samples, every counter. Prints per
    step the gated candidates, the kept count, unmatched and below-margin
    boxes and the largest box and logit errors, and each run's scans/s."""
    here = os.path.dirname(os.path.abspath(__file__))
    rcfg, meta, record = SR.load_record(os.path.join(here,
                                                     SR.RECORD_CALIBRATED))
    if rcfg != dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, compute_dtype="float32")):
        raise AssertionError("the calibrated record is not at the full "
                             "default Config in float32")
    params, state = SR.calibrated_params(cfg)
    if meta["fingerprint"] != SR.fingerprint(params, state):
        raise AssertionError("the calibrated record's weights are not "
                             "calibrated_params'")
    W = cfg.model.n_past_steps
    read = {}
    for route in ("bfloat16", "float32"):
        cfg_r = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, compute_dtype=route))
        ckpt = os.path.join(work, f"ckpt_cal_{route}")
        save_checkpoint_from_trees(ckpt, cfg_r, params, state)
        out = os.path.join(work, f"preb_cal_{route}")
        pred_root = os.path.join(out, cfg_r.experiment_id)
        for name, (seq, fixed) in SR.SEQUENCES.items():
            key = f"calibrated {route} {name}"
            c0 = obs.counters()
            stats, steps = cli_run(ckpt, root, out, seq, fixed, SR.with_maps)
            launches_seq = span_launches(c0)
            n_launch = launches_seq["main"]
            per = stats["per_sequence"][0]
            gates = [step_gates(i, W, o) for i, (o, _) in enumerate(steps)]
            rows = SR.summarize_calibrated(cfg_r, steps, pred_root, seq,
                                           record[name])
            del steps
            try:
                check_gates(gates, launches_seq, W)
            except AssertionError as e:
                failures.append(f"{key}: {e}")
            if n_launch != SPAN_CONVS_PER_STEP * len(rows):
                failures.append(f"{key}: {n_launch} span-conv launches "
                                f"over {len(rows)} steps")
            res = SR.compare_calibrated(record[name], rows, W, route)
            failures += [f"{key}: {f}" for f in res["failures"]]
            res["scans_per_s"] = per["scans"] / per["seconds"]
            read[key] = res
            cols = ("n_gated", "n_gated_got", "boxes", "boxes_got",
                    "boxes_unmatched", "below_margin", "box_abs", "max_abs",
                    "box_logit_abs", "n_box_sample")
            print(f"cli, calibrated weights, {key}: {per['scans']} scans at "
                  f"{res['scans_per_s']:.3f} scans/s on {card}; vs the "
                  f"calibrated JAX record ({res['compared']} of {len(rows)} "
                  f"steps compared, tolerances "
                  f"{SR.TOLERANCES_CALIBRATED[route]}): kept boxes matched "
                  f"one to one above the margin, unmatched at most "
                  f"{res['boxes_unmatched']}, below the margin at most "
                  f"{res['below_margin']}, matched max abs (position and "
                  f"size, yaw, score) {fmt(res['box_abs'])}; logits max abs "
                  f"{res['max_abs']:.3g}"
                  f" (seeded sample), {res['box_logit_abs']:.3g} (in-box "
                  f"sample); {len(res['failures'])} failures")
            print("  per step " + " ".join(cols) + ": " + "; ".join(
                f"{st['step']}: " + " ".join(fmt(st[c]) for c in cols)
                for st in res["steps"] if st["compared"]))
    return read


def phase_overflow(card):
    """The warm-up span plans that leave rows uncovered, on the card: seed
    0's ref-exact and fixed-frame streams (tools/overflow_plans.STREAMS)
    through the pipeline on the card in float32 with the calibrated
    weights, every span conv whose plan reports an overflow captured. Each
    must be one that the overflow record holds (tests/
    torch_overflow_record.py: the port's plain version equal to the JAX
    span kernel on every row there, the uncovered ones included). Per
    conv: the kernel (float32 operands, and bf16) against the plain
    version within TOL x max(1, |plain|), and the float32 kernel's output
    sum against the record's within OVERFLOW_SUM_TOL of its sum of
    |out|."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, OP.RECORD)) as f:
        ref = json.load(f)["convs"]
    cfg = Config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype="float32"))
    params, state = SR.calibrated_params(cfg)
    read, failures = {}, []
    for stream, n_steps in OP.STREAMS:
        caps = OP.capture(cfg, stream, n_steps, params, state, "cuda")
        for name, args in caps.items():
            x_keys, feats_cat, weights, *rest = args
            got = SC.span_conv_parts(*args)
            plain = SC.span_conv_parts_plain(*args)
            b16 = (x_keys, feats_cat.bfloat16(),
                   [w.bfloat16() for w in weights], *rest)
            plain16 = SC.span_conv_parts_plain(*b16)
            e32 = float((got - plain).abs().max()) / max(
                1.0, float(plain.abs().max()))
            e16 = float((SC.span_conv_parts(*b16) - plain16).abs().max()) / \
                max(1.0, float(plain16.abs().max()))
            r = dict(rel_err_f32=e32, rel_err_bf16=e16,
                     uncovered_rows=int(SC.uncovered_rows(
                         x_keys, rest[1], rest[2], rest[3]).sum()))
            if name in ref:
                r["sum_err"] = OP.sum_error(OP.sums(got), ref[name])
            read[name] = r
            if max(e32, e16) > TOL or name not in ref or \
                    r["sum_err"] > OVERFLOW_SUM_TOL:
                failures.append(f"{name}: {r}")
        del caps
    missing = sorted(set(ref) - set(read))
    if missing:
        failures.append(f"record convs not met on the card: {missing}")
    print(f"overflowing warm-up plans on {card}: {len(read)} span convs on "
          f"{len({n.rsplit('/', 1)[0] for n in read})} plans; kernel vs "
          f"plain max rel err f32 "
          f"{max(r['rel_err_f32'] for r in read.values()):.3g}, bf16 "
          f"{max(r['rel_err_bf16'] for r in read.values()):.3g} (tolerance "
          f"{TOL}); output sums vs the overflow record max "
          f"{max(r.get('sum_err', 0.0) for r in read.values()):.3g} of the "
          f"sum of |out| (tolerance {OVERFLOW_SUM_TOL}); " + json.dumps(read))
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("phase_overflow: " + " | ".join(failures))
    return read


def phase_probes():
    """The span-conv design probes through their entry points, each driven
    with its launch counts read just before it and just after.
    Every probe holds each kernel output it times against the plain version
    on the same inputs and raises beyond its tolerance (probe_extract 5e-4,
    span_conv_apply 5e-4, probe_dotshapes 1e-4, x max(1, max|plain|)).
    Returns the ``kernels`` report entries: ms, device ms and plain ms are
    summed over the probe's cases (probe_dotshapes: at one copy per
    shape)."""
    PE.KERNEL.reset_counts()
    ext = PE.main()
    ext_launches = dict(PE.KERNEL.launches)
    c0 = obs.counters()
    prod = PE.main2()
    # every launch counts as a main-window launch; E's also run slots
    n = span_launches(c0)
    prod_launches = {"D": n["main"] - n["slots"], "E": n["slots"]}
    PD.KERNEL.reset_counts()
    dots = PD.main()
    dot_launches = dict(PD.KERNEL.launches)
    counts = {**ext_launches, **prod_launches, **dot_launches}
    if not all(counts.values()):
        raise AssertionError(f"probe kernel launch counters {counts}")

    entries = []
    ext_bound = total_bound(ext)
    for v in PE.VARIANTS:
        entries.append(dict(
            name=f"probe_extract {PE.LABELS[v]}", route="cuda",
            source="insmos_tpu_torch/csrc/probe_extract.cu",
            replaces="tools/probe_extract.py:255",
            launches=ext_launches[v],
            max_abs_err=max(r["variants"][v]["err"] for r in ext),
            ms=sum(r["variants"][v]["ms"] for r in ext),
            device_ms=sum(r["variants"][v]["device_ms"] for r in ext),
            plain_ms=sum(r["plain_ms"] for r in ext),
            bound_ms=ext_bound[0], bound_by=ext_bound[1],
            # one torch.matmul of the taps gathered beforehand
            library_ms=sum(r["library_ms"] for r in ext),
            library_device_ms=sum(r["library_device_ms"] for r in ext)))
    # D runs the main windows alone (span_conv.py::_kernel), E adds the
    # coverage slots (::_gw_kernel)
    for key, what, rep in (("D", "no slots", "1352"),
                           ("E", "with slots", "1394")):
        b_ms, b_by = total_bound([r[key] for r in prod])
        entries.append(dict(
            name=f"span_conv, probe_extract --production {key} ({what})",
            route="cuda", source="insmos_tpu_torch/csrc/span_conv.cu",
            replaces=f"insmos_tpu/sparse/span_conv.py:{rep}",
            launches=prod_launches[key],
            max_abs_err=max(r[key]["err"] for r in prod),
            ms=sum(r[key]["ms"] for r in prod),
            device_ms=sum(r[key]["device_ms"] for r in prod),
            plain_ms=sum(r[key]["plain_ms"] for r in prod),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    dot_bound = total_bound(dots)
    for v in PD.VARIANTS:
        # one copy per shape; device_ms and library_device_ms are
        # torch.profiler's device time per call, beside the events' ms
        e = dict(
            name=f"probe_dot {v}", route="cuda",
            source="insmos_tpu_torch/csrc/probe_dot.cu",
            replaces="tools/probe_dotshapes.py:41",
            launches=dot_launches[v],
            max_abs_err=max(c["err"] for r in dots
                            for c in r["kernel"][v].values()),
            ms=sum(r["kernel"][v][1]["ms"] for r in dots),
            device_ms=sum(r["kernel"][v][1]["device_ms"] for r in dots),
            plain_ms=sum(r["plain_ms"] for r in dots),
            bound_ms=dot_bound[0], bound_by=dot_bound[1],
            library_ms=sum(r["library_ms"] for r in dots),
            library_device_ms=sum(r["library_device_ms"] for r in dots))
        if v == "fma":  # the same call on float32 operands (cuBLAS SGEMM)
            e["library_f32_ms"] = sum(r["library_f32_ms"] for r in dots)
            e["library_f32_device_ms"] = sum(r["library_f32_device_ms"]
                                             for r in dots)
        entries.append(e)
    print(f"probes: probe_extract A/B/C at {len(ext)} cases, D/E at "
          f"{len(prod)} production cases, probe_dot mma/fma at {len(dots)} "
          f"shapes agree with their plain versions; launches {counts}")
    return entries, dict(extract=ext, production=prod, dotshapes=dots)


def micro_entries(readings, replaces):
    """One ``kernels`` entry per TPU kernel of the micro phase: ``replaces``
    maps each probe tag to its TPU kernel's pallas_call, in report order.
    ms, device ms, plain ms, launches and the bound are summed over the
    tag's readings, as are the one-call's events and device ms; a probe
    without a one-call gives None for both."""
    entries = []
    for tag, rep in replaces.items():
        rs = [r for r in readings if r["tag"] == tag]
        b_ms, b_by = total_bound(rs)
        lib = {k: [r[k] for r in rs] for k in ("library_ms",
                                               "library_device_ms")}
        entries.append(dict(
            name=f"{tag} {rs[0]['kernel']}", route="cuda",
            source=rs[0]["source"], replaces=rep,
            launches=sum(r["launches"] for r in rs),
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=sum(r["ms"] for r in rs),
            device_ms=sum(r["device_ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=b_ms, bound_by=b_by,
            **{k: None if None in v else sum(v) for k, v in lib.items()}))
    return entries


def phase_micro():
    """The micro probes T1-T9 (row gather, lower bound, per-lane gather)
    and the rowconv probe T11 through their entry points at the TPU probes'
    full sizes, with every launch count set to 0 just before and read just
    after. Each probe holds every kernel output it times against its plain
    version (gathers and search bit for bit, rowconv within 1e-4 x max(1,
    max|plain|)) and raises otherwise. Returns one ``kernels`` entry per TPU
    kernel (``micro_entries``) and the readings."""
    MK.KERNEL.reset_counts()
    RC.KERNEL.reset_counts()
    readings = [r for mod in MICRO_PROBES for r in mod.main()]
    counts = {**MK.KERNEL.launches, **RC.KERNEL.launches}
    entries = micro_entries(readings, {tag: rep for mod in MICRO_PROBES
                                       for tag, rep in mod.REPLACES.items()})
    if (not all(counts.values()) or not all(e["launches"] for e in entries)
            or sum(e["launches"] for e in entries) != sum(counts.values())):
        raise AssertionError(f"micro kernel launch counters {counts}, per "
                             f"TPU kernel {[e['launches'] for e in entries]}")
    print(f"micro probes: {len(readings)} cases of {len(entries)} TPU kernels "
          f"agree with their plain versions; launches {counts}")
    return entries, readings


def phase_train(card):
    """The training path on the card.

    1. Full width: the full default Config (bf16), batch 1, the HDL-64E
       window with the raycast's moving labels and four boxes
       (tools/measure_train_step.py); one warm step and TRAIN_STEPS timed
       ones (synchronised): each step's losses finite, the gates 0, step
       seconds and peak memory.
    2. One float32 step at the record's cut against both summaries of the
       committed record (the JAX package's step and the port's CPU route),
       within the tolerances the record states; the same step again, and
       the largest difference between the two runs' gradients.
    3. cli/train for 2 epochs on a small synthetic sequence (the training
       steps on the windowed engine, the validation on the span kernels,
       whose launch counts are set to 0 just before and read just after):
       top-2 + last checkpoints, a resume from the last restores its
       optimizer state and step, predict_mos loads the best checkpoint.
    Any failed check raises after the readings are printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    failures = []
    # 1. full width
    cfg = Config()
    full = MT.measure(cfg, "cuda", batch=1, iters=TRAIN_STEPS,
                      labels="raycast")
    for i, loss in enumerate(full["losses"]):
        print(f"  train step {i} ({'warm' if i == 0 else 'timed'}): "
              f"{json.dumps(loss)}")
        if not all(np.isfinite(v) for v in loss.values()):
            failures.append(f"full-width step {i}: losses {loss}")
    if any(full["gates"].values()):
        failures.append(f"full-width gates {full['gates']}")
    print(f"full-width train step (bf16, batch 1, first reading, not a "
          f"benchmark): first {full['first_s']:.3f} s, timed "
          f"{[round(t, 3) for t in full['step_s']]} s, mean "
          f"{full['steady_s']:.3f} s = {full['epochs_per_day']:.2f} "
          f"epochs/day of the reference schedule; peak memory "
          f"{full['peak_gib']:.2f} GiB; gates {full['gates']}; on {card}")

    # 2. the float32 step against the record, twice
    rcfg, meta, recs = TR.load_record(os.path.join(here, TR.RECORD))
    if rcfg != TR.record_config():
        raise AssertionError("the train record is not at record_config()")
    sample = TR.record_sample(rcfg)
    params, state = TR.record_params(rcfg)
    runs = [TR.port_summary(rcfg, params, state, sample, "cuda",
                            with_grads=True) for _ in range(2)]
    record = {}
    for name, ref in recs.items():
        fails, read = TR.compare(ref, runs[0][0], rcfg.train.lr,
                                 meta["tolerances"][name])
        record[name] = read
        print(f"float32 train step against the record's {name} step: "
              f"{json.dumps(read)}")
        failures += [f"record {name}: {f}" for f in fails]
    g0, g1 = runs[0][1], runs[1][1]
    repeat = max((g0[n] - g1[n]).abs().max().item() / max(
        1.0, g0[n].abs().max().item()) for n in g0)
    bitwise = all(torch.equal(g0[n], g1[n]) for n in g0)
    print(f"float32 train step repeated: largest gradient difference "
          f"{repeat:.3g} (relative to max(1, max|g|) of its leaf), equal bit "
          f"for bit: {bitwise}")

    # 3. the CLI
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase_train_",
                            dir=os.path.join(here, "runs"))
    try:
        root = os.path.join(work, "kitti")
        write_synthetic_sequence(root, seq=0, n_scans=6, seed=3,
                                 n_ground=400, n_per_obj=40)
        scfg = small_config()
        scfg = dataclasses.replace(
            scfg,
            data=dataclasses.replace(scfg.data, split_train=(0,),
                                     split_val=(0,), num_workers=2),
            train=dataclasses.replace(scfg.train, batch_size=2))
        cfg_path = os.path.join(work, "cfg.yaml")
        with open(cfg_path, "w") as fh:
            json.dump(scfg.to_dict(), fh)
        out = os.path.join(work, "run")
        args = ["--config", cfg_path, "--data", root, "--out", out]
        c0 = obs.counters()
        ts = train_cli.main(args + ["--epochs", "2", "--bn_reest", "1"])
        launches = span_launches(c0)
        names = sorted(os.listdir(os.path.join(out, "ckpt")))
        last = os.path.join(out, "ckpt", "last")
        _, _, step, opt = load_checkpoint(last, "cuda", with_opt=True)
        resumed = train_cli.main(args + ["--epochs", "2", "--checkpoint",
                                         last])
        restored = resumed.step == step == ts.step and all(
            torch.equal(a.cpu(), b) for k in opt["optimizer"]["state"]
            for a, b in zip(resumed.optimizer.state_dict()["state"][k]
                            .values(), opt["optimizer"]["state"][k].values()))
        best = train_cli.best_checkpoint(out)
        stats = predict_mos.main(["--ckpt", best, "--data_path", root,
                                  "--sequences", "0", "--out",
                                  os.path.join(work, "preb")])
        print(f"train CLI: 2 epochs, {ts.step} steps, checkpoints {names}, "
              f"resume restored the optimizer state and step {step}: "
              f"{restored}; predict_mos on the best checkpoint "
              f"{os.path.basename(best)}: {stats['scans']} scans; span-kernel "
              f"launches in the validation passes {launches}")
        if len(names) != 3 or "last" not in names:
            failures.append(f"train CLI checkpoints {names}")
        if not restored:
            failures.append("train CLI resume did not restore its state")
        if stats["scans"] != 6:
            failures.append(f"predict_mos on the best checkpoint: {stats}")
        if not launches["main"] > 0:
            failures.append(f"validation launched no span kernel {launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase_train: {seconds:.1f} s")
    if failures:
        raise AssertionError("phase_train: " + " | ".join(failures))
    return dict(full=full, record=record, repeat=repeat, bitwise=bitwise,
                launches=launches, seconds=seconds)


def pod_slot(out, i):
    """Slot ``i``'s rows of a pod step's batched outputs."""
    return {k: ({q: w[i] for q, w in v.items()} if k == "overflow" else v[i])
            for k, v in out.items()}


def outputs_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in OUT_KEYS) and all(
        torch.equal(a["overflow"][k], v) for k, v in b["overflow"].items())


def pod_steps(pod, streams, n):
    """``n`` lockstep steps of the streams (one (scans, tfs) a slot)
    through ``pod``, with the span-kernel launch counts and the NMS's host
    copies read just before and just after. Returns (per slot its
    step outputs, the launches, the NMS copies)."""
    S = len(streams)
    got = [[] for _ in range(S)]
    c0 = obs.counters()
    for t in range(n):
        out = pod.push_scans([sc[t] for sc, _ in streams],
                             [tf[t] for _, tf in streams])
        for i in range(S):
            got[i].append(pod_slot(out, i))
    torch.cuda.synchronize()
    launches = span_launches(c0)
    moved = obs.since(c0)
    copies = {"copies": moved["nms.copies"],
              "overflows": moved["nms.pair_overflows"]}
    return got, launches, copies


def slot_against_single(g, r, n_raw, tol):
    """One slot's step against the single-stream pipeline's on the same
    scan: (bit for bit, point logits max abs, failures). Held as
    tools/stream_record holds the card against the JAX record: counters
    exactly, logits within tol["logit_abs"] (and the share of points
    beyond 1e-3), the kept boxes as many, and matched within
    tol["box_abs"] but for tol["box_unmatched_share"] of them."""
    e = (g["point_logits"][:n_raw] - r["point_logits"][:n_raw]).abs()
    diff, share = float(e.max()), float((e > 1e-3).float().mean())
    bad = [f"counter {k}" for k, v in r["overflow"].items()
           if not torch.equal(g["overflow"][k], v)]
    if diff > tol["logit_abs"] or share > tol["share_over_1e_3"]:
        bad.append(f"point logits max abs {diff:.3g}, share over 1e-3 "
                   f"{share:.3g}")
    gb, rb = InferencePipeline.fetch(g, n_raw), InferencePipeline.fetch(r, n_raw)
    unmatched, _ = SR.match_boxes(rb, gb, tol["box_abs"])
    if len(gb["boxes"]) != len(rb["boxes"]) or \
            unmatched > tol["box_unmatched_share"] * len(rb["boxes"]):
        bad.append(f"kept boxes {len(gb['boxes'])} vs {len(rb['boxes'])}, "
                   f"{unmatched} unmatched")
    return outputs_equal(g, r), diff, bad


def load_plan_record():
    """{"<mode>/<seed>": per step, the JAX package's span_overflow per
    plan} of PLAN_RECORD."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, PLAN_RECORD)) as f:
        return {k: [r["span_overflow"] for r in rows]
                for k, rows in json.load(f)["streams"].items()}


def overflow_gates(gates, ref, W):
    """One slot's span-overflow gate: its per-plan span_overflow equal to
    the JAX package's plans' (``ref``, per step) at every step, so 0 on
    every full-window step where the reference covers every row. Returns
    (the steps that differ, the full-window steps where both overflow,
    the warm-up steps where both overflow)."""
    differ = [g["step"] for g in gates
              if g["span_overflow_per_plan"] != ref[g["step"]]]
    full = {g["step"]: g["span_overflow_per_plan"] for g in gates
            if g["span_overflow"] and g["window"] == W}
    warm = {g["step"]: g["span_overflow_per_plan"] for g in gates
            if g["span_overflow"] and g["window"] < W}
    return differ, full, warm


def check_pod(name, cfg, model, streams, route, failures, refs):
    """One mode and route of phase_pod: a pod of len(streams) slots, the
    launch counts and NMS copies read around its run, then each stream
    through its own single-stream pipeline; every slot's outputs against
    the single stream's (slot_against_single, route's TOLERANCES; float32
    also bit for bit: a slot runs the single stream's arithmetic), the
    gates (``refs``: each slot's stream's span_overflow in the JAX
    package's plans, per step), 46 span-conv launches and one NMS copy a
    pod step. Returns (the pod, its readings)."""
    W = cfg.model.n_past_steps
    S, n = len(streams), len(streams[0][0])
    pod = PodInferencePipeline(cfg, model, ["cuda"], slots_per_device=S)
    got, launches, copies = pod_steps(pod, streams, n)
    tol_key = "float32" if route == "float32" else "bfloat16"
    tol = SR.TOLERANCES[tol_key]
    equal, diff, full_steps = [], [], []
    for i, (scans, tfs) in enumerate(streams):
        pipe = InferencePipeline(cfg, model, "cuda")
        eq, d = True, 0.0
        for t, (sc, tf) in enumerate(zip(scans, tfs)):
            e, dt, bad = slot_against_single(got[i][t], pipe.push_scan(sc, tf),
                                             len(sc), tol)
            eq, d = eq and e, max(d, dt)
            if bad:
                failures.append(f"pod {name} {route} slot {i} step {t} vs "
                                f"single stream: " + "; ".join(bad))
        equal.append(eq)
        diff.append(d)
        full_steps.append(pipe.n_full_steps)
    if route == "float32" and not all(equal):
        failures.append(f"pod {name} {route}: slots equal the single "
                        f"stream bit for bit {equal}, point logits {diff}")
    if any(full_steps):
        failures.append(f"pod {name} {route}: single-stream recovery steps "
                        f"{full_steps} (the pod has none)")
    read = dict(equal=equal, logits_max_abs=diff, launches=launches,
                nms_copies=copies, n_full_steps=full_steps)
    # capacity drops gated at 0 at every step of every slot; span
    # overflow gated at every step of every slot against the JAX package's
    # plans on the same stream: 0 on every full-window step where they
    # cover every row (all of seed 0's, as on the main path); where the
    # reference's own plan budgets leave rows uncovered (seed 1, ROADMAP
    # Queue 3) the port leaves the same rows
    warm, full_ovf, gates_ok = {}, {}, True
    for i, gs in enumerate(got):
        gates = [step_gates(t, W, o) for t, o in enumerate(gs)]
        differ, full_ovf[i], warm[i] = overflow_gates(gates, refs[i], W)
        bad = [g for g in gates if g["dropped"]]
        if bad or differ:
            gates_ok = False
            failures.append(f"pod {name} {route} slot {i}: capacity drops "
                            f"{bad}; span_overflow differs from the JAX "
                            f"package's plans at steps {differ}")
    read["warm_span_overflow"] = warm
    read["full_window_span_overflow"] = full_ovf
    if launches["main"] != SPAN_CONVS_PER_STEP * n or not launches["slots"]:
        failures.append(f"pod {name} {route}: span-conv launches "
                        f"{launches}, not {SPAN_CONVS_PER_STEP} a pod step")
    if copies["copies"] != n:
        failures.append(f"pod {name} {route}: NMS host copies {copies} in "
                        f"{n} pod steps")
    print(f"pod, {name}, {route}, S={S}: slots against the single-stream "
          f"pipeline within TOLERANCES[{tol_key}]"
          f" (counters exact), bit for bit {equal}, point logits max abs "
          f"{diff}; single-stream n_full_steps {full_steps}; capacity drops "
          f"0 at every step and span_overflow per plan equal to the JAX "
          f"package's plans at every step of every slot: {gates_ok}; "
          f"full-window steps where both overflow, by slot {full_ovf}; "
          f"warm-up {warm}; span-conv launches {launches} in {n} pod steps; "
          f"NMS host copies {copies}")
    return pod, read


class BatchedRecorder:
    """Records the span-kernel launches over a slot axis (the span op's
    batching rule) of one pod step: span_conv_core_cuda's operands and
    output."""

    def __init__(self):
        self.calls = []
        self._orig = SC.span_conv_core_cuda

    def __enter__(self):
        def rec(x_keys, feats, wg, oc, ov, plan):
            out = self._orig(x_keys, feats, wg, oc, ov, plan)
            if x_keys.dim() == 2:
                self.calls.append(((x_keys, feats, wg, oc, ov, plan), out))
            return out

        SC.span_conv_core_cuda = rec
        return self

    def __exit__(self, *exc):
        SC.span_conv_core_cuda = self._orig


def pod_kernel_check(cfg, model, streams):
    """Every span conv of one full-window pod step of len(streams) slots:
    its one batched launch against the plain version slot by slot (TOL x
    max(1, |plain|)) and against one launch a slot, bit for bit."""
    S, W = len(streams), cfg.model.n_past_steps
    pod = PodInferencePipeline(cfg, model, ["cuda"], slots_per_device=S)
    for t in range(W - 1):
        pod.push_scans([sc[t] for sc, _ in streams],
                       [tf[t] for _, tf in streams])
    with BatchedRecorder() as rec:
        pod.push_scans([sc[W - 1] for sc, _ in streams],
                       [tf[W - 1] for _, tf in streams])
    torch.cuda.synchronize()
    err, rel, equal = 0.0, 0.0, True
    for (xk, f, wg, oc, ov, plan), out in rec.calls:
        for s in range(S):
            p = SC._plan_of(plan.sb[s], plan.emp[s], plan.gp, plan.gs[s],
                            SC._plan_geom(plan))
            core = (xk[s], f[s], wg, oc[s], ov[s])
            ref = SC.span_conv_core_plain(*core, p)
            e = float((out[s] - ref).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(1.0, float(ref.abs().max())))
            equal = equal and torch.equal(out[s],
                                          SC.span_conv_core_cuda(*core, p))
    torch.cuda.synchronize()
    return dict(convs=len(rec.calls), slots=S, max_abs_err=err,
                max_rel_err=rel, equal_single_launches=equal)


def slot_buffers(pod, i):
    """Slot ``i``'s window and caches: its rows of the one device's
    stacked buffer."""
    return {k: (v[i].clone() if isinstance(v, torch.Tensor) else
                {q: w[i].clone() for q, w in v.items()})
            for k, v in pod._buf[0].items()}


def buffers_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else
        all(torch.equal(a[k][q], b[k][q]) for q in a[k]) for k in a)


def pod_rate(cfg, model, S, record):
    """Aggregate scans/s of a pod of S slots on the card over the ref-exact
    streams of seeds 0-3 (slot i streams seed i % 4, which the JAX plan
    record holds): the host clock around POD_TIMED steps after POD_WARM,
    one fence at the end; the span-kernel launches and NMS host copies a
    pod step; on the timed steps, capacity drops gated at 0 and the span
    overflow per plan at the JAX package's plans' (``record``); the peak
    device memory of the run (model included). S = 0 times the
    single-stream pipeline on seed 0's stream instead."""
    W = cfg.model.n_past_steps
    seeds = {i: make_stream(cfg, POD_WARM + POD_TIMED, seed=i)
             for i in range(min(max(S, 1), 4))}
    streams = [seeds[i % 4] for i in range(max(S, 1))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if S:
        pod = PodInferencePipeline(cfg, model, ["cuda"], slots_per_device=S)
        step = lambda t: pod.push_scans(  # noqa: E731
            [sc[t] for sc, _ in streams], [tf[t] for _, tf in streams])
    else:
        pipe = InferencePipeline(cfg, model, "cuda")
        step = lambda t: {k: (v[None] if k != "overflow" else  # noqa: E731
                              {q: w[None] for q, w in v.items()})
                          for k, v in pipe.push_scan(*(x[t] for x in
                                                       streams[0])).items()}
    outs = []
    for t in range(POD_WARM + POD_TIMED):
        if t == POD_WARM:
            torch.cuda.synchronize()
            c0 = obs.counters()
            t0 = time.perf_counter()
        outs.append(step(t))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = obs.since(c0)
    launches = moved["span_conv.launches"] / POD_TIMED
    copies = moved["nms.copies"] / POD_TIMED
    gates = [[step_gates(t, W, pod_slot(o, i)) for i in range(max(S, 1))]
             for t, o in enumerate(outs[POD_WARM:], POD_WARM)]
    bad = [g for row in gates for g in row if g["dropped"]]
    differ = [f"{g['step']}/{i}" for row in gates for i, g in enumerate(row)
              if g["span_overflow_per_plan"]
              != record[f"ref-exact/{i % 4}"][g["step"]]]
    if bad or differ or launches != SPAN_CONVS_PER_STEP or copies != 1:
        raise AssertionError(
            f"pod S={S}: capacity drops on timed steps {bad}; span_overflow "
            f"differs from the JAX package's plans at (step/slot) {differ}; "
            f"span-conv launches a step {launches}; NMS host copies a step "
            f"{copies}")
    # where the reference's own plan budgets leave rows uncovered (the
    # decoder L2 plan on steps 15-19 of seed 0, ROADMAP Queue 3), the
    # timed steps include them: read, per step and slot
    ovf = {f"{g['step']}/{i}": g["span_overflow_per_plan"]
           for row in gates for i, g in enumerate(row) if g["span_overflow"]}
    return dict(S=S, seconds=dt, scans_per_s=max(S, 1) * POD_TIMED / dt,
                step_ms=dt / POD_TIMED * 1e3, launches_per_step=launches,
                nms_copies_per_step=copies,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                span_overflow=ovf)


def phase_pod(card, cfg, params, state, model):
    """Multi-stream (pod) inference on the card, at the full default Config
    with ``init_params(cfg, rng(0))`` weights. The pod runs one step
    vmapped over its slots: one span-kernel launch a conv for all slots, one
    NMS host copy a pod step.

    1. Ref-exact: 2 slots on make_stream seeds 0 and 1 (12 scans each),
       each slot against a single-stream pipeline on its stream (counters
       exactly, logits and kept boxes within tools/stream_record's
       TOLERANCES of the route, float32 bit for bit; bit for bit
       reported), in bf16 (the
       span-kernel launches of this run are the phase's ``launches_pod``)
       and in float32.
    2. Fixed-frame incremental: the same on make_fixed_frame_stream seeds
       0 and 1 (its launches added to ``launches_pod``); a rotated
       transform raises ValueError; then one step with slot 1 idle leaves
       its window and caches untouched.
    3. Gates: capacity drops 0 at every step of every slot; span overflow
       per plan equal at every step of every slot to the JAX package's
       plans on the same stream (PLAN_RECORD), so 0 on every full-window
       step where those cover every row (all of seed 0's); the steps where
       the reference's own plan budgets leave rows uncovered (seed 1's
       full-window steps) are printed with the warm-up counts; 46
       span-conv launches and one NMS host copy a pod step.
    4. The batched kernel: every span conv of one full-window pod step of
       2 slots in each mode (bf16), against the plain version (TOL) and
       against one launch a slot, bit for bit.
    5. A first reading, not a benchmark: aggregate scans/s, pod step ms and
       peak memory at S = 1, 2, 4, 8 over 20 steps of the ref-exact
       streams, beside the single-stream step on the same steps, the timed
       steps gated as in 3; they include steps where the reference's
       decoder L2 budget leaves rows uncovered (steps 15-19 of seed 0),
       printed.
    6. predict_mos --pod --slots_per_device 2 on phase_cli's two sequences
       in float32: its labels equal the serial CLI's byte for byte.
    7. The calibrated weights (stream_record.calibrated_params, a few
       dozen keepers a step): 1 and 3 again in float32 on both modes, the
       slots bit for bit against the single stream, one NMS host copy a
       pod step, the pair-list overflows printed.
    Any failed check raises after the readings are printed."""
    failures, read = [], {}
    record = load_plan_record()
    cfg32 = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype="float32"))
    model32 = make_model(cfg32, params, state, "cuda")
    launches = {"main": 0, "slots": 0}
    read["kernel"] = {}
    for name, fixed in (("ref-exact", False), ("fixed-frame", True)):
        for route, c, m in ((cfg.runtime.compute_dtype, cfg, model),
                            ("float32", cfg32, model32)):
            c = incremental_config(c) if fixed else c
            if fixed:
                streams = [make_fixed_frame_stream(c, N_SCANS + 1, seed=s)
                           for s in (0, 1)]
                extra = [(sc[-1], tf[-1]) for sc, tf, _ in streams]
                streams = [(sc[:-1], tf[:-1]) for sc, tf, _ in streams]
            else:
                streams = [make_stream(c, N_SCANS, seed=s) for s in (0, 1)]
            pod, r = check_pod(name, c, m, streams, route, failures,
                               [record[f"{name}/{s}"] for s in (0, 1)])
            read[f"{name} {route}"] = r
            if route == "float32":
                del pod
                continue
            launches = {k: v + r["launches"][k] for k, v in launches.items()}
            if fixed:
                rot = np.eye(4, dtype=np.float32)
                rot[:2, :2] = [[np.cos(0.05), -np.sin(0.05)],
                               [np.sin(0.05), np.cos(0.05)]]
                try:
                    pod.push_scans([extra[0][0], extra[1][0]], [None, rot])
                    failures.append("pod fixed-frame: a rotated transform "
                                    "did not raise")
                except ValueError as e:
                    print(f"pod, fixed-frame: a rotated transform raises "
                          f"ValueError: {e}")
                before = [slot_buffers(pod, i) for i in (0, 1)]
                pod.push_scans([extra[0][0], None], [extra[0][1], None])
                after = [slot_buffers(pod, i) for i in (0, 1)]
                idle_ok = buffers_equal(before[1], after[1]) and not \
                    buffers_equal(before[0], after[0])
                read["idle_slot_untouched"] = idle_ok
                print(f"pod, fixed-frame: one step with slot 1 idle leaves "
                      f"its window and caches untouched, slot 0 stepped: "
                      f"{idle_ok}")
                if not idle_ok:
                    failures.append("pod: the idle slot's window changed")
            del pod
            k = read["kernel"][name] = pod_kernel_check(c, m, streams)
            print(f"pod, {name}, {route}: the batched span kernel on the "
                  f"{k['convs']} span convs of a full-window pod step of "
                  f"{k['slots']} slots: one launch over both slots equals one "
                  f"launch a slot bit for bit {k['equal_single_launches']}; "
                  f"against the plain version max abs err "
                  f"{k['max_abs_err']:.3g}, / max(1, |plain|) "
                  f"{k['max_rel_err']:.3g} (tolerance {TOL})")
            if k["convs"] != SPAN_CONVS_PER_STEP or k["max_rel_err"] > TOL \
                    or not k["equal_single_launches"]:
                failures.append(f"pod {name}: batched span kernel {k}")
    read["launches"] = launches
    # the calibrated weights (a few dozen keepers a step, the NMS's
    # deployment regime): float32 slots bit for bit against the single
    # stream, one NMS host copy a pod step, pair-list overflows printed
    pc, sc = SR.calibrated_params(cfg32)
    model_c = make_model(cfg32, pc, sc, "cuda")
    for name, fixed in (("ref-exact", False), ("fixed-frame", True)):
        c = incremental_config(cfg32) if fixed else cfg32
        streams = [make_fixed_frame_stream(c, N_SCANS, seed=s)[:2] if fixed
                   else make_stream(c, N_SCANS, seed=s) for s in (0, 1)]
        pod, read[f"{name} calibrated float32"] = check_pod(
            f"{name} calibrated", c, model_c, streams, "float32", failures,
            [record[f"{name}/{s}"] for s in (0, 1)])
        del pod
    del model_c
    rates = [pod_rate(cfg, model, S, record) for S in (0,) + POD_SLOTS]
    read["rates"] = rates
    single = rates[0]
    print(f"pod aggregate scans/s (first reading, not a benchmark; ref-exact "
          f"stream, bf16, {POD_TIMED} timed steps after {POD_WARM}, host "
          f"clock, one fence) on {card}: single-stream pipeline "
          f"{single['scans_per_s']:.3f} scans/s ({single['step_ms']:.1f} ms a "
          f"step, peak {single['peak_gib']:.2f} GiB); pod " + ", ".join(
              f"S={r['S']} {r['scans_per_s']:.3f} scans/s ({r['step_ms']:.1f}"
              f" ms a pod step, peak {r['peak_gib']:.2f} GiB, "
              f"{r['launches_per_step']:.0f} span-conv launches and "
              f"{r['nms_copies_per_step']:.0f} NMS host copy a pod step)"
              for r in rates[1:])
          + "; timed-step span_overflow per plan (step/slot) "
          + json.dumps({r["S"]: r["span_overflow"] for r in rates}))

    # the CLI, float32, against the serial CLI
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase_pod_", dir=os.path.join(here, "runs"))
    try:
        root = os.path.join(work, "kitti")
        SR.write_sequences(root, cfg32, N_SCANS, 0)
        ckpt = os.path.join(work, "ckpt")
        save_checkpoint_from_trees(ckpt, cfg32, params, state)
        seqs = [str(q) for q, _ in SR.SEQUENCES.values()]
        base = ["--ckpt", ckpt, "--data_path", root, "--sequences", *seqs]
        serial = predict_mos.main(base + ["--out", os.path.join(work, "a")])
        podcli = predict_mos.main(base + ["--out", os.path.join(work, "b"),
                                          "--pod", "--slots_per_device", "2"])
        sub = os.path.join(cfg32.experiment_id, "mos_preb", "sequences")
        n_files = n_same = 0
        for q in seqs:
            d = os.path.join(sub, f"{int(q):02d}", "predictions")
            for name in sorted(os.listdir(os.path.join(work, "a", d))):
                with open(os.path.join(work, "a", d, name), "rb") as fa, \
                        open(os.path.join(work, "b", d, name), "rb") as fb:
                    n_same += fa.read() == fb.read()
                n_files += 1
        wave = podcli["waves"][0]
        read["cli"] = dict(files=n_files, equal=n_same, serial=serial,
                           pod=podcli)
        print(f"pod CLI (float32, --pod --slots_per_device 2, sequences "
              f"{seqs}): {n_same} of {n_files} .label files equal the serial "
              f"CLI's byte for byte; {wave['scans']} scans in "
              f"{wave['seconds']:.2f} s = {wave['scans'] / wave['seconds']:.3f}"
              f" scans/s aggregate beside the serial "
              f"{serial['scans'] / serial['seconds']:.3f} on {card}")
        if n_files != len(seqs) * N_SCANS or n_same != n_files:
            failures.append(f"pod CLI: {n_same} of {n_files} label files "
                            "equal the serial CLI's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("phase_pod: " + " | ".join(failures))
    return read


def phase_dp(card):
    """Data-parallel training on the card: ``cli/train`` under torchrun
    (``--standalone --nproc_per_node 1``: NCCL, world 1, so process-group
    setup, replicate, shard_batch and the gradient all-reduce run on the
    card) for 1 epoch at small_config(), batch 2, float32, then the same
    command twice without torchrun; every run in torch's deterministic mode
    (DP_PRELUDE). The final parameters and BN state (each run's ``last``
    checkpoint): the DP run may differ from either plain run by no more
    than the two plain runs differ from each other."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase_dp_", dir=os.path.join(here, "runs"))
    try:
        root = os.path.join(work, "kitti")
        write_synthetic_sequence(root, seq=0, n_scans=6, seed=3,
                                 n_ground=400, n_per_obj=40)
        scfg = small_config()
        scfg = dataclasses.replace(
            scfg, data=dataclasses.replace(scfg.data, split_train=(0,),
                                           split_val=(0,), num_workers=2),
            train=dataclasses.replace(scfg.train, batch_size=2))
        cfg_path = os.path.join(work, "cfg.yaml")
        with open(cfg_path, "w") as fh:
            json.dump(scfg.to_dict(), fh)
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        prelude = [sys.executable, "-c", DP_PRELUDE]
        torchrun = [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", "1", "--no-python"]
        states, secs = {}, {}
        for name, cmd in (("dp", torchrun + prelude), ("plain 1", prelude),
                          ("plain 2", prelude)):
            out = os.path.join(work, name.replace(" ", "_"))
            args = ["--config", cfg_path, "--data", root, "--out", out,
                    "--epochs", "1"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + args, env=env, cwd=here, text=True,
                                  capture_output=True, timeout=600)
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"phase_dp {name}: rc {proc.returncode}"
                                     f"\n{proc.stdout[-3000:]}\n"
                                     f"{proc.stderr[-3000:]}")
            states[name] = torch.load(
                os.path.join(out, "ckpt", "last", "model.pt"),
                map_location="cpu", weights_only=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def diff(a, b):
        sa, sb = states[a]["model"], states[b]["model"]
        return max(float((sa[k].double() - sb[k].double()).abs().max())
                   for k in sa if sa[k].is_floating_point())

    spread = diff("plain 1", "plain 2")
    dp = [diff("dp", "plain 1"), diff("dp", "plain 2")]
    steps = {k: v["step"] for k, v in states.items()}
    print(f"phase_dp: cli/train 1 epoch at small_config, batch 2, float32, "
          f"deterministic mode; torchrun world 1 (NCCL) vs plain runs: "
          f"parameters and BN state max abs diff dp-plain1 {dp[0]:.3g}, "
          f"dp-plain2 {dp[1]:.3g}, plain1-plain2 {spread:.3g}; steps "
          f"{steps}; seconds {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
          f" on {card}")
    if max(dp) > spread or len(set(steps.values())) != 1:
        raise AssertionError(f"phase_dp: the DP run differs by {dp} beyond "
                             f"the plain runs' spread {spread}, steps {steps}")
    return dict(dp_vs_plain=dp, plain_spread=spread, steps=steps,
                seconds=secs)


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

    err, times, classes, bounds = phase_kernels(cfg, model, scans, tfs)
    ref_err = phase_reference(device)
    inc_ref_err = phase_reference(device, incremental=True)
    print(f"small-input reference: card vs CPU point logits max abs err "
          f"{ref_err:.3g} ref-exact, {inc_ref_err:.3g} incremental (tolerance "
          f"1e-3)")
    step_ms, gates, launches, full = phase_main(cfg, model, scans, tfs)
    inc = phase_incremental(cfg, model)
    cli = phase_cli(card)
    overflow = phase_overflow(card)
    pod = phase_pod(card, cfg, params, state, model)

    med = statistics.median(step_ms[i] for i in full)
    print(f"step time (first reading, not a benchmark): median {med:.1f} ms "
          f"over the {len(full)} full-window steps = {1e3 / med:.2f} scans/s "
          f"on {card}; all steps ms {[round(t, 1) for t in step_ms]}")
    inc_med = statistics.median(inc["step_ms"][i] for i in inc["full"])
    per_step = {k: v / N_SCANS for k, v in inc["launches"].items()}
    print(f"incremental step time (first reading, not a benchmark): median "
          f"{inc_med:.1f} ms over the {len(inc['full'])} full-window steps "
          f"= {1e3 / inc_med:.2f} scans/s, beside the ref-exact step's "
          f"{med:.1f} ms, on {card}; all steps ms "
          f"{[round(t, 1) for t in inc['step_ms']]}; span-conv launches per "
          f"step: incremental {per_step}, ref-exact "
          f"{ {k: v / N_SCANS for k, v in launches.items()} }")
    probe_entries, probes = phase_probes()
    micro_entries, probes["micro"] = phase_micro()
    train = phase_train(card)
    dp = phase_dp(card)
    print(f"device_ms profiler sessions: {tools.SESSIONS['whole']} whole, "
          f"{tools.SESSIONS['short']} short and run again, "
          f"{tools.SESSIONS['events']} calls timed by CUDA events instead")
    probes["profiler_sessions"] = dict(tools.SESSIONS)
    report = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "insmos_tpu_torch/csrc/span_conv.cu", "replaces": rep,
         "launches": launches[key], "max_abs_err": err[key],
         "ms": times[key], "plain_ms": times[key + "_plain"],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
         "library_ms": None,
         # the incremental mode's main path: launches over its N_SCANS
         # steps, and the largest error of its full-window step's convs
         "launches_incremental": inc["launches"][key],
         "max_abs_err_incremental": inc["kernel_err"][key],
         # predict_mos over both full-config sequences
         "launches_cli": cli["launches"][key],
         # the training slice: the validation passes of cli/train
         "launches_train": train["launches"][key],
         # pod inference: 12 pod steps of 2 slots in each mode, bf16,
         # one launch a conv for both slots
         "launches_pod": pod["launches"][key]}
        for (name, rep), key in zip(KERNELS, ("main", "slots"))
    ] + probe_entries + micro_entries}
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as fh:
            json.dump(dict(card=card, report=report, classes=classes,
                           step_ms=step_ms, gates=gates, ref_err=ref_err,
                           incremental=inc, incremental_ref_err=inc_ref_err,
                           cli=cli, overflow=overflow, train=train,
                           pod=pod, dp=dp,
                           probes=probes), fh, indent=1)
    for name, c in sorted(list(classes.items()) + [
            ("(incremental) " + k, v) for k, v in inc["classes"].items()]):
        print(f"  class {name}: kernel {c['kernel_ms']:.3f} ms, bound "
              f"{c['bound_ms']:.4f} ms set by {c['bound_by']}, share of "
              f"bound {c['share_of_bound']:.4f}; {json.dumps(c)}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
