"""Matrix-product rates of the span kernel's dot shapes on the card (port
of tools/probe_dotshapes.py).

For each of the TPU probe's 12 shapes, ``csrc/probe_dot.cu`` computes the
sum of REP * n_dots products a @ b (bf16 operands, float32 accumulation) in
two variants: ``mma`` on the tensor cores (wmma bf16 tiles) and ``fma`` on
the CUDA cores in float32 (the way the span kernel's fold runs). Each runs
with one copy of the problem (one problem's tiles) and with one copy per SM
(the card's rate). ``dot_plain`` is the plain PyTorch version that every
output is held against.

    python -m insmos_tpu_torch.tools.probe_dotshapes

Needs one CUDA device. Times are CUDA-event readings of the card named on
the first line of the output.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from .. import setup_device
from ..kernels import KernelEntry, bound
from ..sparse import span_conv as SC
from . import card_line, cuda_ms, max_err

DEVICE = torch.device("cuda")
REP = 64  # products per launch and dot shape (the TPU probe's REP)
VARIANTS = ("mma", "fma")
# |kernel - plain| <= TOL * max(1, max|plain|): exact bf16 products summed
# in float32 in another order, up to REP * K = 262,144 terms
TOL = 1e-4
TILE_M, TILE_N, TILE_K = 128, 64, 32  # csrc/probe_dot.cu takes multiples

_p, _i = ctypes.c_void_p, ctypes.c_int
# a, b, out; M, K, N, reps, copies, variant; stream
KERNEL = KernelEntry("probe_dot", [_p] * 3 + [_i] * 6 + [_p], VARIANTS)

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


def dot_cuda(a, b, reps, variant, copies=1):
    """The kernel of csrc/probe_dot.cu: (copies, M, N) float32, every copy
    the sum dot_plain computes, launched once on the current stream. CUDA
    bf16 tensors only, M, N, K multiples of the kernel's tile."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"dot_cuda needs CUDA tensors, got {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    (M, K), N = a.shape, b.shape[1]
    if M % TILE_M or N % TILE_N or K % TILE_K or M == 0 or N == 0 or K == 0:
        raise ValueError(f"shape ({M},{K})@({K},{N}) is not a multiple of "
                         f"({TILE_M},{TILE_K})@({TILE_K},{TILE_N})")
    if not (1 <= reps and 1 <= copies <= 65535):
        raise ValueError(f"reps={reps} copies={copies}")
    SC._check(a, "a", torch.bfloat16, (M, K), dev)
    SC._check(b, "b", torch.bfloat16, (K, N), dev)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    out = torch.empty((copies, M, N), dtype=torch.float32, device=dev)
    KERNEL(variant, a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
           reps, copies, VARIANTS.index(variant),
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def run_shape(name, M, K, N, n_dots, copies=(1,), iters=10):
    """Both variants at every copies setting against the plain version,
    then timed: µs per product (over reps and copies) and TF/s."""
    reps = REP * n_dots
    a, b = (torch.from_numpy(x).to(DEVICE, torch.bfloat16)
            for x in make_operands(M, K, N))
    ref = dot_plain(a, b, reps)
    plain_ms = cuda_ms(lambda: dot_plain(a, b, reps), 1)
    # one PyTorch call for the same sum: (M, reps*K) @ (reps*K, N)
    a_cat, b_cat = a.repeat(1, reps), b.repeat(reps, 1)
    library_ms = cuda_ms(lambda: torch.matmul(a_cat, b_cat), iters)
    del a_cat, b_cat
    fl = 2 * M * K * N
    # one copy: a and b read once, the float32 sum written once
    res = dict(name=name, M=M, K=K, N=N, reps=reps, plain_ms=plain_ms,
               library_ms=library_ms, kernel={v: {} for v in VARIANTS},
               **bound(2 * (M * K + K * N) + 4 * M * N, fl * reps))
    for v in VARIANTS:
        for c in copies:
            err, scale = max_err(dot_cuda(a, b, reps, v, c), ref)
            if err > TOL * scale:
                raise AssertionError(
                    f"{name} {v} copies={c}: kernel vs plain max abs err "
                    f"{err:.3g} > {TOL} x {scale:.3g}")
            ms = cuda_ms(lambda: dot_cuda(a, b, reps, v, c), iters)
            us = ms * 1e3 / (reps * c)
            res["kernel"][v][c] = dict(ms=ms, us_per_dot=us,
                                       tflops=fl / us / 1e6, err=err)
            print(f"{name:32s} {v} copies={c:<4d} {us:9.3f} us/dot "
                  f"{fl / us / 1e6:8.2f} TF/s  max abs err {err:.3g}",
                  flush=True)
    us = plain_ms * 1e3 / reps
    print(f"{name:32s} plain        {us:9.3f} us/dot {fl / us / 1e6:8.2f} "
          f"TF/s", flush=True)
    return res


def main(iters=10):
    setup_device(DEVICE)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return [run_shape(*s, copies=(1, sms), iters=iters) for s in SHAPES]


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_dotshapes: needs a CUDA device")
    print(card_line(), flush=True)
    main()


if __name__ == "__main__":
    cli()
