"""Span-kernel extraction probe on the card (port of tools/probe_extract.py).

Default mode: the TPU probe's synthetic single-part span conv, at its four
MotionNet and UNet cases (G = 9 groups, kx = 3 taps, blocks of bs = 128
sites). Block b's site i queries key q_i = 2 (b bs + i) over keys that
advance by 2, so taps d = 0 and 2 hit and d = 1 never does; a tap counts only
inside the group's window of ``span`` key rows starting at row sb[g, b]*16.
``csrc/probe_extract.cu`` runs it in three variants (A: one binary search
per tap, one fold; B: the same taps, one fold pass per tap; C: one lower
bound and a forward scan, one fold), each a bf16 fold on the tensor cores;
``extract_plain`` is the plain PyTorch version that each output is held
against. Beside them it times one ``torch.matmul`` of the taps gathered
beforehand (``extract_gathered``) by the stacked weights: a PyTorch rate on
the same fold FLOPs, which the port never calls.

``--production``: the port's span plan and ``span_conv_apply`` (the
production kernel, ``csrc/span_conv.cu``) on synthetic site sets of the same
widths, D without and E with the plan's coverage slots, against
``span_conv_parts_plain``.

    python -m insmos_tpu_torch.tools.probe_extract [--production]

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses

import numpy as np
import torch

from .. import setup_device
from ..kernels import KernelEntry, bound
from ..sparse import span_conv as SC
from . import card_line, cuda_ms, device_ms, max_err

DEVICE = torch.device("cuda")
VARIANTS = ("A", "B", "C")
LABELS = {"A": "A tap-wise search", "B": "B tap-wise fold passes",
          "C": "C one search + scan"}
# |kernel - plain| <= TOL * max(1, max|plain|), the span kernel's tolerance:
# both sum the same exact float32 products of bf16 operands, in another
# order, over kx*TCP = 1152 terms per group and 9 groups
TOL = 5e-4
KX_MAX, BS_MAX, SPAN_MAX = 5, 128, 512  # limits of csrc/probe_extract.cu

_p, _i = ctypes.c_void_p, ctypes.c_int
# keys, q, feats, wg, sb, out; V, nrows, NB, bs, G, kx, TCP, TOP, span,
# variant; stream
KERNEL = KernelEntry("probe_extract", [_p] * 6 + [_i] * 10 + [_p], VARIANTS)

# name, V, TCP, TOP, span (tools/probe_extract.py:278-282); G=9, kx=3, bs=128
CASES = [
    ("MotionNet L2 block", 327_680, 128, 128, 256),
    ("MotionNet L8 block", 65_536, 384, 384, 384),
    ("UNet L1 (C=16)", 100_096 // 128 * 128, 128, 128, 256),
    ("UNet L4 (C=128)", 24_576, 128, 128, 384),
]
# name, V, C_in, C_out, T, span (tools/probe_extract.py:347-352); G=9, kx=3
PRODUCTION_CASES = [
    ("MotionNet L2-like", 327_680, 8, 8, 10, 256),
    ("MotionNet L8-like", 65_536, 32, 32, 10, 384),
    ("UNet L1-like", 99_968, 16, 16, 1, 256),
]


def make_case(V, TCP, TOP, span, G, kx, bs, seed=0):
    """The TPU probe's synthetic case in numpy: (sb (G, NB) int32, q (V,)
    int32, keys (nr16*16 + span,) int32, feats (V + span + 16, TCP) float32,
    wg (G, kx*TCP, TOP) float32). sb, feats and wg are the TPU probe's
    (feats and wg before their bf16 cast); keys is its padded key array,
    of which the TPU's keys2 holds row r as keys[r*16 : r*16 + span]."""
    rng = np.random.default_rng(seed)
    NB = -(-V // bs)
    keys = np.arange(V, dtype=np.int32) * 2
    nr16 = V // 16 + 17
    kpad = np.concatenate([keys, np.full(nr16 * 16 + span - V, 2**30,
                                         np.int32)])
    feats = rng.normal(0, 1, (V + span + 16, TCP)).astype(np.float32)
    wg = rng.normal(0, 0.1, (G, kx * TCP, TOP)).astype(np.float32)
    sb = np.maximum(np.arange(NB, dtype=np.int32) * bs // 16 - 2, 0)
    sb = np.broadcast_to(sb, (G, NB)).copy()
    q = np.arange(V, dtype=np.int32) * 2
    return sb, q, kpad, feats, wg


def case_tensors(case, device):
    """make_case's arrays on ``device``: (keys, q, feats bf16, wg bf16, sb),
    in the argument order of extract_plain and extract_cuda."""
    sb, q, keys, feats, wg = case
    t = [torch.from_numpy(a).to(device) for a in (keys, q, feats, wg, sb)]
    return (t[0], t[1], t[2].to(torch.bfloat16), t[3].to(torch.bfloat16),
            t[4])


def _extract_taps(keys, q, sb, nrows, *, kx, span, bs):
    """(pos (V, kx), ok (G, V, kx)): each tap's key row found by
    searchsorted over all keys, and whether it lies inside the block's
    window [sb*16, sb*16 + span) of each group."""
    V = q.shape[0]
    dev = q.device
    keys64 = keys.to(torch.int64)
    qd = q.to(torch.int64)[:, None] + torch.arange(kx, device=dev)  # (V, kx)
    pos = torch.searchsorted(keys64, qd.reshape(-1)).reshape(V, kx)
    hit = (pos < nrows) & (keys64[pos.clamp(max=keys.shape[0] - 1)] == qd)
    blk = torch.arange(V, device=dev) // bs
    start = sb.to(torch.int64)[:, blk][..., None] * 16  # (G, V, 1)
    return pos, hit & (pos >= start) & (pos < start + span)


def extract_plain(keys, q, feats, wg, sb, *, kx, span, bs):
    """Plain PyTorch version: each tap's key row is found by searchsorted
    over all keys and accepted only inside the block's window
    [sb*16, sb*16 + span) (the span-restricted semantics of
    span_conv_core_plain); products in float32, summed in float32."""
    V = q.shape[0]
    G, _, TOP = wg.shape
    nf, TCP = feats.shape
    pos, ok = _extract_taps(keys, q, sb, min(keys.shape[0], nf), kx=kx,
                            span=span, bs=bs)
    fpad = torch.cat([feats.float(), feats.new_zeros((1, TCP)).float()])
    out = torch.zeros((V, TOP), dtype=torch.float32, device=feats.device)
    for g in range(G):
        rows = torch.where(ok[g], pos, nf)
        out += fpad[rows].reshape(V, kx * TCP) @ wg[g].float()
    return out


def extract_gathered(keys, q, feats, wg, sb, *, kx, span, bs):
    """The one-call yardstick's operands, built outside the timed call:
    (X (V, G*kx*TCP), every site's row for every group and tap gathered,
    zero where the tap misses or lies outside the window; the weights
    stacked (G*kx*TCP, TOP)), in feats' and wg's types. X @ W is
    extract_plain's output."""
    V = q.shape[0]
    G, _, TOP = wg.shape
    nf, TCP = feats.shape
    pos, ok = _extract_taps(keys, q, sb, min(keys.shape[0], nf), kx=kx,
                            span=span, bs=bs)
    fpad = torch.cat([feats, feats.new_zeros((1, TCP))])
    rows = torch.where(ok, pos, nf)  # (G, V, kx)
    X = fpad[rows.permute(1, 0, 2)].reshape(V, G * kx * TCP)
    return X, wg.reshape(G * kx * TCP, TOP)


def extract_bound(keys, q, feats, wg, sb, *, kx, span, bs):
    """kernels.bound of one extraction: 2 * TCP * TOP FLOPs per matched
    (site, group, tap), every input read once and the float32 output
    written once."""
    V, (nf, TCP), TOP = q.shape[0], feats.shape, wg.shape[2]
    _, ok = _extract_taps(keys, q, sb, min(keys.shape[0], nf), kx=kx,
                          span=span, bs=bs)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (keys, q, feats, wg, sb)) + 4 * V * TOP
    return bound(nbytes, 2 * int(ok.sum()) * TCP * TOP)


def extract_cuda(keys, q, feats, wg, sb, *, kx, span, bs, variant):
    """The kernel of csrc/probe_extract.cu (same contract as
    extract_plain), launched once on the current stream. CUDA tensors
    only; TCP and TOP multiples of 8 (16-byte pieces), feats and wg
    16-byte aligned."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"extract_cuda needs CUDA tensors, got {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if not (1 <= kx <= KX_MAX and 1 <= bs <= BS_MAX
            and 1 <= span <= SPAN_MAX):
        raise ValueError(f"unsupported geometry kx={kx} bs={bs} span={span}")
    V = q.shape[0]
    G, _, TOP = wg.shape
    nf, TCP = feats.shape
    if TCP < 8 or TCP % 8 or TOP % 8:
        raise ValueError(f"unsupported geometry TCP={TCP} TOP={TOP}: the "
                         "kernel takes multiples of 8")
    NB = -(-V // bs)
    SC._check(keys, "keys", torch.int32, (keys.shape[0],), dev)
    SC._check(q, "q", torch.int32, (V,), dev)
    SC._check(feats, "feats", torch.bfloat16, (nf, TCP), dev)
    SC._check(wg, "wg", torch.bfloat16, (G, kx * TCP, TOP), dev)
    SC._check(sb, "sb", torch.int32, (G, NB), dev)
    if feats.data_ptr() % 16 or wg.data_ptr() % 16:
        raise ValueError("feats and wg must be 16-byte aligned")
    out = torch.empty((V, TOP), dtype=torch.float32, device=dev)
    KERNEL(variant, keys.data_ptr(), q.data_ptr(), feats.data_ptr(),
           wg.data_ptr(), sb.data_ptr(), out.data_ptr(), V,
           min(keys.shape[0], nf), NB, bs, G, kx, TCP, TOP, span,
           VARIANTS.index(variant),
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def _check_tol(what, err, scale):
    if err > TOL * scale:
        raise AssertionError(f"{what}: kernel vs plain max abs err {err:.3g} "
                             f"> {TOL} x {scale:.3g}")


def run_case(name, V, TCP, TOP, span, G, kx=3, bs=128, iters=10):
    """Every variant against the plain version on one case, then timed,
    and the one-call yardstick timed (``extract_gathered``). Returns the
    times, errors and the fold rate per variant."""
    print(f"{name}: V={V} TCP={TCP} TOP={TOP} span={span} G={G}", flush=True)
    args = case_tensors(make_case(V, TCP, TOP, span, G, kx, bs), DEVICE)
    geo = dict(kx=kx, span=span, bs=bs)
    ref = extract_plain(*args, **geo)
    plain_ms = cuda_ms(lambda: extract_plain(*args, **geo), 1)
    # fold FLOPs only: the TPU probe's rate (tools/probe_extract.py:271) also
    # counted its one-hot extraction dots, which this kernel does not run
    fl = 2 * V * G * kx * TCP * TOP
    res = dict(name=name, V=V, TCP=TCP, TOP=TOP, span=span, G=G,
               plain_ms=plain_ms, variants={}, **extract_bound(*args, **geo))
    for v in VARIANTS:
        err, scale = max_err(extract_cuda(*args, **geo, variant=v), ref)
        _check_tol(f"{name} {LABELS[v]}", err, scale)

        def fn():
            return extract_cuda(*args, **geo, variant=v)

        ms, dev_ms = cuda_ms(fn, iters), device_ms(fn, iters)
        res["variants"][v] = dict(ms=ms, device_ms=dev_ms,
                                  tflops=fl / dev_ms / 1e9, err=err)
        print(f"  {LABELS[v]:28s} {ms:9.3f} ms, device {dev_ms:9.3f} ms  "
              f"{fl / dev_ms / 1e9:7.2f} TF/s fold  max abs err {err:.3g}",
              flush=True)
    print(f"  {'plain':28s} {plain_ms:9.3f} ms  "
          f"{fl / plain_ms / 1e9:7.2f} TF/s fold", flush=True)
    X, W = extract_gathered(*args, **geo)

    def one_call():
        return torch.matmul(X, W)

    res.update(library_ms=cuda_ms(one_call, iters),
               library_device_ms=device_ms(one_call, iters))
    del X, W
    print(f"  {'one call (matmul)':28s} {res['library_ms']:9.3f} ms, device "
          f"{res['library_device_ms']:9.3f} ms  "
          f"{fl / res['library_device_ms'] / 1e9:7.2f} TF/s fold", flush=True)
    return res


def main(iters=10):
    setup_device(DEVICE)
    return [run_case(*c, G=9, iters=iters) for c in CASES]


# ---------------------------------------------------------------------------
# Production mode: the same widths through the port's span plan and
# span_conv_apply.
#   D  span_conv_apply without the plan's coverage slots
#   E  span_conv_apply with them
# ---------------------------------------------------------------------------

def make_sites(V, C_in, C_out, T, kx=3, G=9, seed=0, dims=(600, 500, 20)):
    """The TPU probe's synthetic site set, V distinct random cells of an
    (X, Y, Z) grid sorted by key: (keys (V,) int32 sorted,
    coords (V, 3) int32, valid (V,) bool, feats (V, T*C_in) float32,
    w (kx*G, C_in, C_out) float32)."""
    rng = np.random.default_rng(seed)
    X, Y, Z = dims
    nneed = V * 2
    flat = np.sort(rng.choice(X * Y * Z, size=nneed, replace=False)[:V]
                   ).astype(np.int32)
    coords = np.stack([flat % X, (flat // X) % Y, flat // (X * Y)],
                      axis=1).astype(np.int32)
    keys = ((coords[:, 2].astype(np.int64) * Y + coords[:, 1]) * X
            + coords[:, 0]).astype(np.int32)
    order = np.argsort(keys)
    keys, coords = keys[order], coords[order]
    valid = np.ones((V,), bool)
    feats = rng.normal(0, 1, (V, T * C_in)).astype(np.float32)
    w = rng.normal(0, 0.1, (kx * G, C_in, C_out)).astype(np.float32)
    return keys, coords, valid, feats, w


def run_production(name, V, C_in, C_out, T, span, G, kx=3, bs=128, seed=0,
                   iters=10):
    """D and E against span_conv_parts_plain on one site set, then timed."""
    keys, coords, valid, feats, w = (
        torch.from_numpy(a).to(DEVICE)
        for a in make_sites(V, C_in, C_out, T, kx, G, seed))
    w = w.to(torch.bfloat16)
    plan = SC.make_span_plan(keys, coords, valid, (kx, 3, 3),
                             in_dims=(600, 500, 20),
                             span=span, bs=bs, slots=1024, gwin=16)
    novf = int(plan.n_overflow)
    live = int((plan.gs[1] >= 0).sum())
    print(f"{name}: V={V} T={T} C={C_in}->{C_out} span={span} "
          f"overflow={novf} live slots={live}", flush=True)
    plan0 = dataclasses.replace(
        plan, gs=torch.zeros((4, 0), dtype=torch.int32, device=DEVICE), js=0)
    part = (SC.ConvPart(C_in, C_out, T),)
    res = dict(name=name, V=V, T=T, C_in=C_in, C_out=C_out, span=span,
               n_overflow=novf, live_slots=live)
    for key, label, p in (("D", "D production, no slots", plan0),
                          ("E", "E production + slots", plan)):
        def run():
            return SC.span_conv_apply(keys, feats, coords, valid, w, p, T)

        def plain():
            return SC.span_conv_parts_plain(keys, feats, [w], part, coords,
                                            valid, p, T)

        err, scale = max_err(run(), plain())
        _check_tol(f"{name} {label}", err, scale)
        ms, dev_ms = cuda_ms(run, iters), device_ms(run, iters)
        plain_ms = cuda_ms(plain, 1)
        fw = SC._prepare(feats, [w], part, p, T)
        work = SC.span_conv_work(keys, *fw, coords, valid, p)
        res[key] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, err=err,
                        bound_ms=work["bound_ms"], bound_by=work["bound_by"])
        print(f"  {label:28s} {ms:9.3f} ms, device {dev_ms:9.3f} ms  plain "
              f"{plain_ms:9.3f} ms  max abs err {err:.3g}", flush=True)
    return res


def main2(iters=10):
    setup_device(DEVICE)
    return [run_production(*c, G=9, iters=iters) for c in PRODUCTION_CASES]


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--production", action="store_true",
                    help="run D/E through the port's span plan and "
                         "span_conv_apply")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_extract: needs a CUDA device")
    print(card_line(), flush=True)
    (main2 if args.production else main)()


if __name__ == "__main__":
    cli()
