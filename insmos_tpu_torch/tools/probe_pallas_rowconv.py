"""Rowdense submanifold conv probe on the card (port of
tools/probe_pallas_rowconv.py, a prototype conv engine on dense rows):

    T11  a level of R rows of W = 16 slots, each slot an x coordinate
         (SENT = 2^30 when empty) and C = 16 bf16 features. For each of G
         row shifts s and kx = 3 x offsets dx, slot w of row r takes every
         slot j of row r + s with x_j == x_w + dx, through that (group, dx)'s
         (C, COUT = 16) weight, summed in float32 (rowconv).

The semantics are those of the TPU probe's jnp reference ``ref_conv``
(:45-65), not of its Pallas body, whose ``pltpu.repeat`` tiles the match
mask where it meant to repeat each element and so scrambles its im2col.
Two cases: the TPU probe's small case (:188-201, R=512, 9 groups) and its
L1-4D case (:204-207, R=399,360, 27 groups). The kernel output
(csrc/rowconv.cu) is held against ``rowconv_plain`` within TOL x max(1,
max|plain|), then both are timed; it prints useful TF/s,
2 * matches * C * COUT / t.

    python -m insmos_tpu_torch.tools.probe_pallas_rowconv

Needs one CUDA device. Times are readings of the card named on the first
line of the output: CUDA events and torch.profiler's device time per
call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import setup_device
from ..kernels import KernelEntry, bound
from ..sparse import span_conv as SC
from . import cuda_ms, device_ms, max_err
from . import micro_kernels as MK

SENT = 2**30
W, C, COUT = 16, 16, 16  # slots per row, channels in and out (both cases)
X_OFF = (-1, 0, 1)
# |kernel - plain| <= TOL * max(1, max|plain|): the same exact float32
# products of bf16 operands, summed in another order
TOL = 1e-4
G_MAX, KX_MAX, GK_MAX = 64, 8, 90  # limits of csrc/rowconv.cu
REPLACES = {"T11": "tools/probe_pallas_rowconv.py:155"}

_p, _i = ctypes.c_void_p, ctypes.c_int
# xs, feats, w, shifts, x_off, out; R, W, G, kx; stream
KERNEL = KernelEntry("rowconv", [_p] * 6 + [_i] * 4 + [_p], ("rowconv",))


def shifts_3x3(Y):
    """Flat row shifts of a 3x3 (dy, dz) neighbourhood, Y rows per z."""
    return [dy + Y * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)]


# name, R, X, density, shifts (tools/probe_pallas_rowconv.py:188-190,
# :193; :204-208, 40,000 rows per t)
CASES = [
    ("small", 512, 200, 4.0, shifts_3x3(16)),
    ("L1-4D", 399_360, 1200, 3.0,
     [s + 40_000 * dt for dt in (-1, 0, 1) for s in shifts_3x3(1000)]),
]


def make_level(R, W, C, X, density, seed=0):
    """A random rowdense level with the TPU probe's distributions (:23-42):
    each row holds min(Poisson(density), W) valid slots, the smallest of W
    uniform x in [0, X) in ascending order (duplicates kept: the probe's
    dedupe is a no-op), the rest SENT; features standard normal, 0 on empty
    slots. Returns xs (R, W) int32 and feats (R, W * C) float32 (the caller
    casts them to bf16)."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.poisson(density, R), W)
    xs = np.sort((rng.uniform(size=(R, W)) * X).astype(np.int32), axis=1)
    ok = np.arange(W)[None, :] < counts[:, None]
    xs = np.where(ok, xs, SENT).astype(np.int32)
    feats = (rng.normal(size=(R, W * C)) * np.repeat(ok, C, axis=1)
             ).astype(np.float32)
    return xs, feats


def make_weights(n, C, COUT, seed=0):
    """(n, C, COUT) float32 weights, normal with std 0.1 (:194, :209)."""
    return (np.random.default_rng(seed).normal(size=(n, C, COUT)) * 0.1
            ).astype(np.float32)


def _shifted(a, s, fill):
    """b[r] = a[r + s] where 0 <= r + s < len(a), else ``fill``."""
    b = torch.full_like(a, fill)
    R = a.shape[0]
    if s >= 0:
        b[:max(R - s, 0)] = a[s:]
    else:
        b[-s:] = a[:max(R + s, 0)]
    return b


def _match_masks(xs, shifts, x_off):
    """For each (g, k): m (R, W, W) bool, m[r, w, j] where slot j of row
    r + shifts[g] holds xs[r, w] + x_off[k] and the center is not SENT
    (rows outside the level hold SENT and match nothing valid)."""
    center = (xs < SENT)[:, :, None]
    for g, s in enumerate(shifts):
        nxs = _shifted(xs, s, SENT)
        for k, dx in enumerate(x_off):
            yield g, k, (nxs[:, None, :] == xs[:, :, None] + dx) & center


def rowconv_plain(xs, feats, w, shifts, x_off):
    """Plain PyTorch version: per (group, dx), the (R, W, W) match mask
    gathers the neighbour row's features (every duplicate match summed),
    then the (C, COUT) weight; float32 throughout. xs (R, W) int32, feats
    (R, W * C), w (G * kx, C, COUT) → (R, W * COUT) float32."""
    R, Wn = xs.shape
    Cn, COUTn = w.shape[1:]
    f3 = feats.reshape(R, Wn, Cn).float()
    w4 = w.reshape(len(shifts), len(x_off), Cn, COUTn).float()
    out = torch.zeros((R, Wn, COUTn), dtype=torch.float32, device=xs.device)
    nf = None
    for g, k, m in _match_masks(xs, shifts, x_off):
        if k == 0:
            nf = _shifted(f3, shifts[g], 0.0)
        out += torch.bmm(m.float(), nf) @ w4[g, k]
    return out.reshape(R, Wn * COUTn)


def count_matches(xs, shifts, x_off):
    """Matched (center, neighbour slot, group, dx) tuples: the useful work
    of one conv is 2 * matches * C * COUT FLOPs."""
    return sum(int(m.sum()) for _, _, m in _match_masks(xs, shifts, x_off))


def rowconv_cuda(xs, feats, w, shifts, x_off):
    """The kernel of csrc/rowconv.cu (same contract as rowconv_plain, C =
    COUT = 16, bf16 feats and w), launched once on the current stream.
    CUDA tensors only."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"rowconv_cuda needs CUDA tensors, got {dev}")
    G, kx = len(shifts), len(x_off)
    if xs.dim() != 2 or xs.shape[0] == 0 or xs.shape[1] == 0:
        raise ValueError(f"xs shape {tuple(xs.shape)}: expected (R, W)")
    if not (1 <= G <= G_MAX and 1 <= kx <= KX_MAX and G * kx <= GK_MAX):
        raise ValueError(f"G={G} kx={kx}: the kernel takes G <= {G_MAX}, "
                         f"kx <= {KX_MAX}, G * kx <= {GK_MAX}")
    R, Wn = xs.shape
    SC._check(xs, "xs", torch.int32, (R, Wn), dev)
    SC._check(feats, "feats", torch.bfloat16, (R, Wn * C), dev)
    SC._check(w, "w", torch.bfloat16, (G * kx, C, COUT), dev)
    if feats.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("feats and w must be 16-byte aligned")
    sh = torch.tensor(shifts, dtype=torch.int32, device=dev)
    dx = torch.tensor(x_off, dtype=torch.int32, device=dev)
    out = torch.empty((R, Wn * COUT), dtype=torch.float32, device=dev)
    KERNEL("rowconv", xs.data_ptr(), feats.data_ptr(), w.data_ptr(),
           sh.data_ptr(), dx.data_ptr(), out.data_ptr(), R, Wn, G, kx,
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def run_case(name, R, X, density, shifts, x_off=X_OFF, seed=0, iters=10,
             plain_iters=3):
    """The kernel against the plain version on one level, then timed."""
    xs, feats = make_level(R, W, C, X, density, seed)
    w = make_weights(len(shifts) * len(x_off), C, COUT, seed + 1)
    xs, feats, w = MK.to_device(xs, feats, w)
    feats, w = feats.to(torch.bfloat16), w.to(torch.bfloat16)
    args = (xs, feats, w, shifts, x_off)
    before = KERNEL.launches["rowconv"]
    got = rowconv_cuda(*args)
    err, scale = max_err(got, rowconv_plain(*args))
    # xs, feats and weights read once, the float32 output written once
    nbytes = sum(t.numel() * t.element_size() for t in (xs, feats, w, got))
    del got
    if err > TOL * scale:
        raise AssertionError(f"T11 {name}: kernel vs plain max abs err "
                             f"{err:.3g} > {TOL} x {scale:.3g}")
    matches = count_matches(xs, shifts, x_off)
    ms = cuda_ms(lambda: rowconv_cuda(*args), iters)
    dev_ms = device_ms(lambda: rowconv_cuda(*args), iters)
    plain_ms = cuda_ms(lambda: rowconv_plain(*args), plain_iters)
    fl = 2 * matches * C * COUT
    res = dict(tag="T11", name=f"rowconv {name} R={R} G={len(shifts)}",
               kernel="rowconv", source="insmos_tpu_torch/csrc/rowconv.cu",
               ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=err,
               scale=scale, launches=KERNEL.launches["rowconv"] - before,
               unit="TF/s", rate=fl / dev_ms / 1e9,
               plain_rate=fl / plain_ms / 1e9, matches=matches,
               valid=int((xs < SENT).sum()), library_ms=None,
               library_device_ms=None, **bound(nbytes, fl))
    print(f"T11 {res['name']:40s} {ms:9.4f} ms, device {dev_ms:9.4f} ms "
          f"{res['rate']:7.3f} TF/s  "
          f"plain {plain_ms:9.3f} ms {res['plain_rate']:7.3f} TF/s  "
          f"{matches} matches of {res['valid']} centers, max abs err "
          f"{err:.3g}", flush=True)
    return res


def main(iters=10):
    setup_device(MK.DEVICE)
    return [run_case(*c, iters=iters) for c in CASES]


def cli(argv=None):
    MK.probe_cli(__doc__, main, argv)


if __name__ == "__main__":
    cli()
