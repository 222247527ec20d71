"""Matrix-product rates of the span kernel's dot shapes on the card (port
of tools/probe_dotshapes.py).

For each of the TPU probe's 12 shapes, ``csrc/probe_dot.cu`` computes the
sum of REP * n_dots products a @ b (bf16 operands, float32 accumulation) in
two variants: ``mma`` on the tensor cores (wgmma fed by TMA) and ``fma`` on
the CUDA cores in float32 (the CUDA-core ceiling of the span kernel's fold
tiling). Each runs with one copy of the problem, its reps split across the
card (``dot_splits``), and with one copy per SM (the card's rate).
``dot_plain`` is the plain PyTorch version that every output is held
against. Beside each: one long-K ``torch.matmul`` of the operands
concatenated over the reps, in bf16 and (for ``fma``) in float32.

    python -m insmos_tpu_torch.tools.probe_dotshapes [--sweep]

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events over back-to-back calls (``ms``, which
include the wrappers' host time once it exceeds the kernel's) and
torch.profiler's device time per call (``device_ms``).
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from .. import setup_device
from ..kernels import KernelEntry, bound
from ..sparse import span_conv as SC
from . import card_line, cuda_ms, device_ms, max_err

DEVICE = torch.device("cuda")
REP = 64  # products per launch and dot shape (the TPU probe's REP)
VARIANTS = ("mma", "fma")
# |kernel - plain| <= TOL * max(1, max|plain|): exact bf16 products summed
# in float32 in another order, up to REP * K = 262,144 terms
TOL = 1e-4
TILE_M, TILE_N, TILE_K = 128, 64, 8  # csrc/probe_dot.cu takes multiples
BLOCK_M, BLOCK_N = 128, 128  # the output tile of one thread block
MAX_GRID_Z = 65535

_p, _i = ctypes.c_void_p, ctypes.c_int
# a, b, out, ws, tickets; M, K, N, reps, copies, splits, variant; stream
KERNEL = KernelEntry("probe_dot", [_p] * 5 + [_i] * 7 + [_p], VARIANTS)
# per device: int32 ticket counters, zero between launches (each launch
# leaves them at zero)
_TICKETS: dict = {}

# name, M, K, N, n_dots (tools/probe_dotshapes.py:72-83)
SHAPES = [
    ("extract (128,256)@(256,128)", 128, 256, 128, 1),
    ("extract x3 shapes", 128, 256, 128, 3),
    ("wide-N (128,256)@(256,384)", 128, 256, 384, 1),
    ("wide-N (128,256)@(256,512)", 128, 256, 512, 1),
    ("wide-N (128,256)@(256,1024)", 128, 256, 1024, 1),
    ("fold (128,384)@(384,128)", 128, 384, 128, 1),
    ("fold wide (128,384)@(384,384)", 128, 384, 384, 1),
    ("M256 (256,256)@(256,128)", 256, 256, 128, 1),
    ("M256 wide (256,256)@(256,384)", 256, 256, 384, 1),
    ("M512 wide (512,256)@(256,512)", 512, 256, 512, 1),
    ("bigK (128,1024)@(1024,128)", 128, 1024, 128, 1),
    ("bigK (128,4096)@(4096,128)", 128, 4096, 128, 1),
]


def tiles(M, N):
    """Output tiles of one copy: ceil(M / 128) x ceil(N / 128)."""
    return -(-M // BLOCK_M) * -(-N // BLOCK_N)


def dot_splits(M, N, reps, copies, sms):
    """The split of each copy's reps over thread blocks: the count S that
    fills the card in one wave of one block per SM, the largest with
    tiles x copies x S <= sms (a block past it would run in a second wave
    alone), at least 1, at most ``reps`` and with copies x S <= 65535 (the
    grid's z). Returns (S, the reps range (r0, r1) of each split, in
    order); split s runs reps [s*reps//S, (s+1)*reps//S), as the kernel
    computes them."""
    fill = sms // (tiles(M, N) * copies)
    S = max(1, min(reps, fill, MAX_GRID_Z // copies))
    return S, [(s * reps // S, (s + 1) * reps // S) for s in range(S)]


def make_operands(M, K, N, seed=0):
    """Standard-normal (M, K) and (K, N) float32 operands (the caller casts
    them to bf16)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(K, N)).astype(np.float32))


def dot_plain(a, b, reps):
    """sum over ``reps`` of a @ b, each product in float32 and added into a
    float32 accumulator in turn."""
    af, bf = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for _ in range(reps):
        acc += af @ bf
    return acc


@functools.lru_cache(maxsize=None)
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tickets(dev, n):
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = _TICKETS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=dev)
    return t


def dot_cuda(a, b, reps, variant, copies=1, splits=None):
    """The kernel of csrc/probe_dot.cu: (copies, M, N) float32, every copy
    the sum dot_plain computes, launched once on the current stream, each
    copy's reps split over ``splits`` blocks per tile (default
    ``dot_splits`` for this card). CUDA bf16 tensors only, M, N, K
    multiples of (TILE_M, TILE_N, TILE_K)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"dot_cuda needs CUDA tensors, got {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    (M, K), N = a.shape, b.shape[1]
    if M % TILE_M or N % TILE_N or K % TILE_K or M == 0 or N == 0 or K == 0:
        raise ValueError(f"shape ({M},{K})@({K},{N}) is not a multiple of "
                         f"({TILE_M},{TILE_K})@({TILE_K},{TILE_N})")
    if splits is None:
        splits = dot_splits(M, N, reps, copies, _sms(dev))[0]
    if not (1 <= splits <= reps and 1 <= copies
            and copies * splits <= MAX_GRID_Z):
        raise ValueError(f"reps={reps} copies={copies} splits={splits}")
    SC._check(a, "a", torch.bfloat16, (M, K), dev)
    SC._check(b, "b", torch.bfloat16, (K, N), dev)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    out = torch.empty((copies, M, N), dtype=torch.float32, device=dev)
    # the split partials and the tiles' tickets (splits > 1 only)
    ws = torch.empty((copies, splits, M, N) if splits > 1 else (0,),
                     dtype=torch.float32, device=dev)
    tickets = _tickets(dev, copies * tiles(M, N)) if splits > 1 else ws
    KERNEL(variant, a.data_ptr(), b.data_ptr(), out.data_ptr(),
           ws.data_ptr() if splits > 1 else 0,
           tickets.data_ptr() if splits > 1 else 0,
           M, K, N, reps, copies, splits, VARIANTS.index(variant),
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def run_shape(name, M, K, N, n_dots, copies=(1,), iters=10):
    """Both variants at every copies setting against the plain version (and
    two launches against each other, bit for bit), then timed by events
    and by device time: µs per product (over reps and copies) and TF/s."""
    reps = REP * n_dots
    a, b = (torch.from_numpy(x).to(DEVICE, torch.bfloat16)
            for x in make_operands(M, K, N))
    ref = dot_plain(a, b, reps)
    plain_ms = cuda_ms(lambda: dot_plain(a, b, reps), 1)
    fl = 2 * M * K * N
    # one copy: a and b read once, the float32 sum written once
    res = dict(name=name, M=M, K=K, N=N, reps=reps, plain_ms=plain_ms,
               kernel={v: {} for v in VARIANTS},
               **bound(2 * (M * K + K * N) + 4 * M * N, fl * reps))
    # one PyTorch call for the same sum: (M, reps*K) @ (reps*K, N), in bf16
    # and in float32 (cuBLAS SGEMM: setup_device turns TF32 off)
    for key, dt in (("library", torch.bfloat16), ("library_f32", torch.float32)):
        a_cat, b_cat = a.to(dt).repeat(1, reps), b.to(dt).repeat(reps, 1)
        res[key + "_ms"] = cuda_ms(lambda: torch.matmul(a_cat, b_cat), iters)
        res[key + "_device_ms"] = device_ms(lambda: torch.matmul(a_cat, b_cat),
                                            iters)
        del a_cat, b_cat
    sms = _sms(DEVICE)
    for v in VARIANTS:
        for c in copies:
            got = dot_cuda(a, b, reps, v, c)
            err, scale = max_err(got, ref)
            if err > TOL * scale:
                raise AssertionError(
                    f"{name} {v} copies={c}: kernel vs plain max abs err "
                    f"{err:.3g} > {TOL} x {scale:.3g}")
            if not torch.equal(got, dot_cuda(a, b, reps, v, c)):
                raise AssertionError(f"{name} {v} copies={c}: two launches "
                                     f"differ")
            ms = cuda_ms(lambda: dot_cuda(a, b, reps, v, c), iters)
            dev_ms = device_ms(lambda: dot_cuda(a, b, reps, v, c), iters)
            us = dev_ms * 1e3 / (reps * c)
            S = dot_splits(M, N, reps, c, sms)[0]
            res["kernel"][v][c] = dict(ms=ms, device_ms=dev_ms, splits=S,
                                       us_per_dot=us, tflops=fl / us / 1e6,
                                       err=err)
            print(f"{name:32s} {v} copies={c:<4d} splits={S:<4d} events "
                  f"{ms:9.4f} ms, device {dev_ms:9.4f} ms, {fl / us / 1e6:8.2f}"
                  f" TF/s  max abs err {err:.3g}", flush=True)
    print(f"{name:32s} one call bf16 events {res['library_ms']:9.4f} ms, "
          f"device {res['library_device_ms']:9.4f} ms; float32 events "
          f"{res['library_f32_ms']:9.4f} ms, device "
          f"{res['library_f32_device_ms']:9.4f} ms; plain loop "
          f"{plain_ms:9.4f} ms", flush=True)
    return res


def sweep_splits(iters=10, counts=(1, 2, 4, 8, 16, 32, 64, 128)):
    """Device ms per call of each variant at one copy, per shape, for each
    split count in ``counts`` (up to the shape's reps) and dot_splits' own:
    what the split and its reduction cost against each other."""
    setup_device(DEVICE)
    rows = []
    for name, M, K, N, n_dots in SHAPES:
        reps = REP * n_dots
        a, b = (torch.from_numpy(x).to(DEVICE, torch.bfloat16)
                for x in make_operands(M, K, N))
        pick = dot_splits(M, N, reps, 1, _sms(DEVICE))[0]
        for v in VARIANTS:
            ms = {S: device_ms(lambda: dot_cuda(a, b, reps, v, 1, S), iters)
                  for S in sorted({*counts, pick}) if S <= reps}
            rows.append(dict(name=name, variant=v, dot_splits=pick,
                             device_ms=ms))
            print(f"{name:32s} {v} dot_splits {pick:<4d} device ms by "
                  f"splits: " + ", ".join(f"{S}: {t:.4f}"
                                          for S, t in ms.items()), flush=True)
    return rows


def main(iters=10):
    setup_device(DEVICE)
    return [run_shape(*s, copies=(1, _sms(DEVICE)), iters=iters)
            for s in SHAPES]


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="device ms at one copy for a range of split counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_dotshapes: needs a CUDA device")
    print(card_line(), flush=True)
    sweep_splits() if args.sweep else main()


if __name__ == "__main__":
    cli()
