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
checks the outputs and the overflow gates, and prints a first step time. Then it runs the
span-conv design probes (insmos_tpu_torch.tools.probe_extract, with and
without --production, and probe_dotshapes) at their full case lists, each
kernel held against its plain version, and last the micro probes (T1-T9:
micro_pallas, micro_pallas2, micro_lanegather, micro_lanegather2,
probe_tala) and the rowconv probe (T11: probe_pallas_rowconv) at the TPU
probes' full sizes. Any failure raises and ends the run with a non-zero
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
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from insmos_tpu_torch import kernels, setup_device, tools
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.hdl64 import make_stream
from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.sparse import span_conv as SC
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
from insmos_tpu_torch.utils.params import init_params, make_model

N_SCANS = 12
# |kernel - plain| <= TOL * max(1, max|plain|): both sum the same exact
# float32 products (bf16 operands widen exactly), in another order, over
# up to kx*TC = 1440 terms per group (bf16: per group on the tensor cores)
# plus the groups and slots
TOL = 5e-4
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


def phase_kernels(cfg, model, scans, tfs):
    """Kernel vs plain on every span conv of one full-window step, with the
    bound of each (SC.span_conv_work on its bf16 operands)."""
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
    need = ["stem 5x5x5", "down 2x2x2 s2 +occ", "cat t-pruned",
            "unet 3x3x3 subm", "unet 3x3x3 s2p1", "conv_out", "span192",
            "span256", "span384"]
    missing = [n for n in need if not any(n in c for c in classes)]
    if missing:
        raise AssertionError(f"shape classes not exercised: {missing}")
    if not any(c["live_slots"] for c in classes.values()):
        raise AssertionError("no recorded conv had live coverage slots")
    torch.cuda.synchronize()
    for c in classes.values():
        c["bound_by"] = ("operations" if c.pop("bound_ops_ms")
                         > c["bound_ms"] / 2 else "bytes")
        c["share_of_bound"] = c["bound_ms"] / c["kernel_ms"]
    print(f"kernel vs plain: {len(rec.calls)} span convs of one full-window "
          f"step agree within {TOL} x max(1, |plain|) in bf16 and f32 "
          f"(max abs err main {err['main']:.3g}, with slots {err['slots']:.3g};"
          f" bf16 max abs err / max(1, |plain|) {rel:.3g})")
    return err, times, classes, {k: total_bound(v) for k, v in bounds.items()}


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


def phase_probes():
    """The span-conv design probes through their entry points, each driven
    with its launch counts set to 0 just before it and read just after.
    Every probe holds each kernel output it times against the plain version
    on the same inputs and raises beyond its tolerance (probe_extract 5e-4,
    span_conv_apply 5e-4, probe_dotshapes 1e-4, x max(1, max|plain|)).
    Returns the ``kernels`` report entries: ms, device ms and plain ms are
    summed over the probe's cases (probe_dotshapes: at one copy per
    shape)."""
    PE.KERNEL.reset_counts()
    ext = PE.main()
    ext_launches = dict(PE.KERNEL.launches)
    SC.SPAN_KERNELS.reset_counts()
    prod = PE.main2()
    # every launch counts as a main-window launch; E's also run slots
    prod_launches = {"D": (SC.SPAN_KERNELS.main_launches
                           - SC.SPAN_KERNELS.slot_launches),
                     "E": SC.SPAN_KERNELS.slot_launches}
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
            bound_ms=ext_bound[0], bound_by=ext_bound[1], library_ms=None))
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
    print(f"small-input reference: card vs CPU point logits max abs err "
          f"{ref_err:.3g} (tolerance 1e-3)")
    step_ms, gates, launches, full = phase_main(cfg, model, scans, tfs)

    med = statistics.median(step_ms[i] for i in full)
    print(f"step time (first reading, not a benchmark): median {med:.1f} ms "
          f"over the {len(full)} full-window steps = {1e3 / med:.2f} scans/s "
          f"on {card}; all steps ms {[round(t, 1) for t in step_ms]}")
    probe_entries, probes = phase_probes()
    micro_entries, probes["micro"] = phase_micro()
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
         "library_ms": None}
        for (name, rep), key in zip(KERNELS, ("main", "slots"))
    ] + probe_entries + micro_entries}
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as fh:
            json.dump(dict(card=card, report=report, classes=classes,
                           step_ms=step_ms, gates=gates, ref_err=ref_err,
                           probes=probes), fh, indent=1)
    for name, c in sorted(classes.items()):
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
