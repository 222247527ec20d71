"""The micro-probe kernels of csrc/micro_gather.cu and csrc/rowconv.cu
against their plain PyTorch versions (needs the card).

gather_rows at widths 1, 3, 8 and 128 (16-, 8- and 4-byte pieces, and
tables that are only 4-byte aligned at widths 2, 4, 8 and 128; width 1
with a query count that is not a multiple of 4, a misaligned table or
index), lower_bound at 1 to 2^22 keys (the cases of lower_bound_cases.py:
the tree of every key in shared memory, or of buckets of 2 to 128 keys
finished from global memory; T at the layout's boundaries; keys with
repeats, all equal, or holding INT_MIN and INT_MAX; the band keys[0] < q
<= keys[1]; one query; queries or keys only 4-byte aligned; a repeat call),
lane_gather at S from 8 to 384 with staged windows and
windows read from L2, rows that are not a multiple of the block, lanes
that are not a multiple of 32, staged windows split over many blocks,
T5's full case from L2, lanes not a multiple of 4, op or idx only 4-byte
aligned: all must match exactly. rowconv on the TPU probe's small case,
on levels whose shifts reach past both ends, with every row empty, with
all 16 slots of every row valid, with duplicate x in the neighbour rows
(summed), and with 5 slots a row over an odd number of rows, within 1e-4 x
max(1, max|plain|) (the same exact float32 products of bf16 operands,
summed in another order); every empty center's output is exactly 0.

Run on the card with:
    python -m pytest --noconftest -m gpu tests/test_torch_micro_kernels.py
(--noconftest: the repository's conftest imports jax, which the GPU
machine does not have).
"""

import lower_bound_cases as LBC
import numpy as np
import pytest
import torch

from insmos_tpu_torch import setup_device
from insmos_tpu_torch.tools import micro_kernels as MK
from insmos_tpu_torch.tools import probe_pallas_rowconv as RC

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return setup_device("cuda")


def _exact(kernel, plain, variant, kernel_entry=MK.KERNEL):
    before = kernel_entry.launches[variant]
    got = kernel()
    torch.cuda.synchronize()
    assert kernel_entry.launches[variant] == before + 1
    ref = plain()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _table(rng, T, width, dtype, dev, misaligned=False):
    shape = (T,) if width is None else (T, width)
    a = (rng.normal(size=shape) * 1000).astype(dtype)
    if not misaligned:
        return torch.from_numpy(a).to(dev)
    flat = torch.empty(a.size + 1, dtype=torch.from_numpy(a).dtype,
                       device=dev)
    t = flat[1:].view(shape)  # 4 bytes past an aligned start
    t.copy_(torch.from_numpy(a))
    return t


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("width,Q,misaligned", [
    (None, 1000, False), (1, 4097, False), (3, 1000, False),
    (8, 4097, False), (128, 1000, False), (4, 777, True), (2, 999, True),
    (8, 1000, True), (128, 300, True)],
    ids=["1d", "w1", "w3", "w8", "w128", "w4_misaligned", "w2_misaligned",
         "w8_misaligned", "w128_misaligned"])
def test_gather_rows_matches_plain(width, Q, misaligned, dtype, cuda):
    rng = np.random.default_rng(Q)
    table = _table(rng, 513, width, dtype, cuda, misaligned)
    idx = torch.from_numpy(rng.integers(0, 513, Q).astype(np.int32)).to(cuda)
    _exact(lambda: MK.gather_rows_cuda(table, idx),
           lambda: MK.gather_rows_plain(table, idx), "rows")


def _misaligned(t):
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("Q", [4096, 4097, 4098, 4099, 3])
@pytest.mark.parametrize("where", ["table", "idx"])
def test_gather_rows_w1_misaligned_matches_plain(Q, where, cuda):
    rng = np.random.default_rng(Q)
    table = torch.from_numpy(rng.integers(-2**31, 2**31, 70_001)
                             .astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 70_001, Q).astype(np.int32)
                           ).to(cuda)
    if where == "table":
        table = _misaligned(table)
    else:
        idx = _misaligned(idx)
    _exact(lambda: MK.gather_rows_cuda(table, idx),
           lambda: MK.gather_rows_plain(table, idx), "rows")


@pytest.mark.parametrize("kind,T,qshape", LBC.CASES, ids=LBC.IDS)
def test_lower_bound_matches_plain(kind, T, qshape, cuda):
    keys, q = (torch.from_numpy(a).to(cuda)
               for a in LBC.make_case(kind, T, qshape))
    if kind == "q_skew":
        q = _misaligned(q)
    elif kind == "keys_skew":
        keys = _misaligned(keys)
    _exact(lambda: MK.lower_bound_cuda(keys, q),
           lambda: MK.lower_bound_plain(keys, q), "bsearch")
    got = MK.lower_bound_cuda(keys, q)
    # a repeat call gives the same bits
    assert torch.equal(got, MK.lower_bound_cuda(keys, q))
    if kind == "random" and T > 1:
        band = (q.flatten() > keys[0]) & (q.flatten() <= keys[1])
        assert bool((got.flatten()[band] == 1).all())


# rows, L, S, stride, op_rows (None: (rows / S) * stride)
LANE_CASES = [
    (64 * 8, 128, 8, 8, None),
    (16 * 32 - 3, 128, 32, 32, None),
    (7 * 100, 40, 100, 100, None),
    (8 * 256, 128, 256, 256, None),
    (4 * 384 + 5, 72, 384, 384, None),
    (10 * 32, 128, 32, 48, None),      # windows 48 rows apart
    (8, 128, 8, 0, 16),                # T9: one staged window
    (1000, 128, 1000, 0, 8192),        # T5: one window, read from L2
    (1000, 33, 250, 0, 500),           # four windows over the same rows
]


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("case", LANE_CASES,
                         ids=[f"r{c[0]}_L{c[1]}_S{c[2]}_st{c[3]}"
                              for c in LANE_CASES])
def test_lane_gather_matches_plain(case, dtype, cuda):
    rows, L, S, stride, op_rows = case
    nb = -(-rows // S)
    op_rows = op_rows or nb * stride
    span = stride or op_rows
    rng = np.random.default_rng(rows + S)
    op = torch.from_numpy((rng.normal(size=(op_rows, L)) * 1000)
                          .astype(dtype)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, span, (rows, L))
                           .astype(np.int32)).to(cuda)
    _exact(lambda: MK.lane_gather_cuda(op, idx, S, stride),
           lambda: MK.lane_gather_plain(op, idx, S, stride), "lane")


# rows, L, S, stride, op_rows (None: (rows / S) * stride), which array is
# only 4-byte aligned
LANE_ALIGN_CASES = [
    (384, 128, 384, 0, 384, None),      # one staged window, 64 chunks
    (257, 96, 384, 0, 384, None),       # a partial window
    (70 * 256 - 50, 128, 256, 256, None, None),  # 2 passes a block
    (5 * 64 + 7, 30, 64, 64, None, None),   # L % 4 != 0
    (3 * 200, 64, 200, 250, None, "op"),    # stride > S
    (3 * 200, 64, 200, 200, None, "idx"),
    (8192, 128, 8192, 0, 8192, None),   # T5, from L2
    (8192, 128, 8192, 0, 8192, "op"),
    (1003, 36, 500, 600, None, None),   # windows 600 rows apart, from L2
    (1003, 36, 500, 600, None, "idx"),
    (777, 6, 100, 0, 20_000, None),     # L % 4 != 0, from L2
    (100, 128, 100, 0, 385, None),      # the smallest span from L2
]


@pytest.mark.parametrize("case", LANE_ALIGN_CASES,
                         ids=[f"r{c[0]}_L{c[1]}_S{c[2]}_st{c[3]}"
                              f"{'_' + c[5] if c[5] else ''}"
                              for c in LANE_ALIGN_CASES])
def test_lane_gather_paths_match_plain(case, cuda):
    rows, L, S, stride, op_rows, skew = case
    op_rows = op_rows or -(-rows // S) * stride
    rng = np.random.default_rng(rows + L)
    op = torch.from_numpy(rng.integers(-2**31, 2**31, (op_rows, L))
                          .astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, stride or op_rows, (rows, L))
                           .astype(np.int32)).to(cuda)
    if skew == "op":
        op = _misaligned(op)
    elif skew == "idx":
        idx = _misaligned(idx)
    _exact(lambda: MK.lane_gather_cuda(op, idx, S, stride),
           lambda: MK.lane_gather_plain(op, idx, S, stride), "lane")


def _level(R, W, X, density, shifts, seed):
    xs, feats = RC.make_level(R, W, RC.C, X, density, seed)
    w = RC.make_weights(len(shifts) * len(RC.X_OFF), RC.C, RC.COUT, seed)
    xs, feats, w = (torch.from_numpy(a).cuda() for a in (xs, feats, w))
    return xs, feats.bfloat16(), w.bfloat16()


_PAST_ENDS = [-70, -63, -5, -1, 0, 2, 9, 63, 70]


# name, R, W, X, density, shifts
@pytest.mark.parametrize("case", [
    ("small", 512, RC.W, 200, 4.0, RC.CASES[0][4]),
    ("past_both_ends", 64, RC.W, 40, 6.0, _PAST_ENDS),
    ("27_groups", 20_000, RC.W, 300, 3.0,
     [s + 2000 * dt for dt in (-1, 0, 1) for s in RC.shifts_3x3(100)]),
    ("all_rows_empty", 300, RC.W, 40, 0.0, RC.CASES[0][4]),
    ("all_slots_valid", 257, RC.W, 24, 100.0, _PAST_ENDS),
    ("duplicate_x", 300, RC.W, 6, 8.0, RC.shifts_3x3(16)),
    ("w5_odd_rows", 33, 5, 20, 3.0, [-3, -1, 0, 1, 40]),
], ids=lambda c: c[0])
def test_rowconv_matches_plain(case, cuda):
    name, R, W, X, density, shifts = case
    xs, feats, w = _level(R, W, X, density, shifts, seed=R)
    valid = xs < RC.SENT
    if name == "all_rows_empty":
        assert not bool(valid.any())
    if name == "all_slots_valid":
        assert bool(valid.all())
    if name == "duplicate_x":  # a row holding one x twice
        assert bool(((xs[:, 1:] == xs[:, :-1]) & valid[:, 1:]).any())
    before = RC.KERNEL.launches["rowconv"]
    got = RC.rowconv_cuda(xs, feats, w, shifts, RC.X_OFF)
    torch.cuda.synchronize()
    assert RC.KERNEL.launches["rowconv"] == before + 1
    ref = RC.rowconv_plain(xs, feats, w, shifts, RC.X_OFF)
    assert got.shape == ref.shape == (R, W * RC.COUT)
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= RC.TOL * scale
    assert (float(ref.abs().max()) > 0) == (name != "all_rows_empty")
    empty = (~valid).repeat_interleave(RC.COUT, 1)
    assert bool((got[empty] == 0).all())


def test_cuda_wrappers_check_inputs(cuda):
    f = torch.zeros((8, 128), dtype=torch.float32, device=cuda)
    i = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        MK.gather_rows_cuda(f.double(), i[0])
    with pytest.raises(ValueError):
        MK.gather_rows_cuda(f, i)  # idx must be 1-D
    with pytest.raises(ValueError):  # not contiguous
        MK.lane_gather_cuda(torch.zeros((128, 8), device=cuda).t(), i, 8, 0)
    with pytest.raises(ValueError):
        MK.lane_gather_cuda(f, i, 4, 8)  # windows past op's rows
    with pytest.raises(ValueError):
        MK.lower_bound_cuda(i[0, :0], i)  # no keys
    with pytest.raises(ValueError):  # more than 16 slots a row
        RC.rowconv_cuda(i[:, :17], torch.zeros((8, 17 * RC.C), device=cuda,
                                               dtype=torch.bfloat16),
                        torch.zeros((3, RC.C, RC.COUT), device=cuda,
                                    dtype=torch.bfloat16), [0], RC.X_OFF)
