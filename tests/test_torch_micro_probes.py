"""The port's micro probes (insmos_tpu_torch/tools: micro_kernels and the
T1-T9 and T11 probe modules) against the TPU probes of tools/ on the CPU,
at small sizes.

The T1-T8 Pallas bodies are nested in their probes' main() and
tools/probe_tala.py runs at import, so their bodies and grid specs are
rebuilt here (each cites its lines) and run in interpret mode.
tools/probe_pallas_rowconv.py is loaded from its file.

Tolerances: gathers bit for bit. The searches agree with the TPU bodies
except on keys[0] < q <= keys[1], where the bodies' ceil(log2 T) halvings
return 0 (a lower bound has T + 1 answers and needs ceil(log2(T + 1))); the
port gives searchsorted's 1 there. T11: the port's plain version against
ref_conv within 1e-4 x max(1, max|ref|) (the same exact float32 products of
bf16 operands, summed in another order); against pallas_conv with its tiled
mask repaired within 1e-2 x max(1, max|ref|) (the body sums duplicate
matches in bf16).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from insmos_tpu_torch.tools import micro_kernels as MK
from insmos_tpu_torch.tools import micro_lanegather2 as MLG2
from insmos_tpu_torch.tools import micro_pallas as MP
from insmos_tpu_torch.tools import micro_pallas2 as MP2
from insmos_tpu_torch.tools import probe_pallas_rowconv as RC
from insmos_tpu_torch.tools import probe_tala as PT

REPO = Path(__file__).resolve().parents[1]
VMEM = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)


def _t(a):
    return torch.from_numpy(np.array(a))


def _take_rows(t_ref, i_ref, o_ref):
    # tools/micro_pallas.py:48-49 (T1), :121-122 (T3); micro_pallas2.py:39-40
    o_ref[:] = jnp.take(t_ref[:], i_ref[:], axis=0)


def _tala(t_ref, i_ref, o_ref):
    # tools/micro_pallas2.py:68-69 (T5), micro_lanegather.py:27-28 (T7),
    # micro_lanegather2.py:23-24 (T8), probe_tala.py:12-13 (T9)
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=0)


def _row_gather_call(table, idx, tile):
    """tools/micro_pallas.py:51-62 / :124-135, micro_pallas2.py:42-53: the
    whole table resident, idx and out in tiles of ``tile`` rows."""
    T = table.shape[0]
    rest = table.shape[1:]
    zeros = (0,) * len(rest)
    return np.asarray(pl.pallas_call(
        _take_rows,
        out_shape=jax.ShapeDtypeStruct((idx.shape[0],) + rest, table.dtype),
        grid=(idx.shape[0] // tile,),
        in_specs=[VMEM((T,) + rest, lambda i: (0,) + zeros),
                  VMEM((tile,), lambda i: (i,))],
        out_specs=VMEM((tile,) + rest, lambda i: (i,) + zeros),
        interpret=True,
    )(jnp.asarray(table), jnp.asarray(idx)))


@pytest.mark.parametrize("probe", ["T1", "T3", "T4"])
def test_gather_rows_plain_matches_tpu_body(probe):
    rng = np.random.default_rng(1)
    T, Q, tile = 512, 4096, 1024
    if probe == "T1":  # micro_pallas.py:43-44, an int32 table
        table = rng.integers(0, 2**30, T).astype(np.int32)
    elif probe == "T3":  # :116, width 8
        table = rng.normal(size=(T, 8)).astype(np.float32)
    else:  # micro_pallas2.py:36, width 128
        T, Q, tile = 64, 1024, 256
        table = rng.normal(size=(T, 128)).astype(np.float32)
    idx = rng.integers(0, T, Q).astype(np.int32)
    got = _row_gather_call(table, idx, tile)
    ref = MK.gather_rows_plain(_t(table), _t(idx)).numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype
    np.testing.assert_array_equal(ref.view(np.int32), got.view(np.int32))


def _bsearch_kernel(T):
    steps = int(np.ceil(np.log2(T)))  # tools/micro_pallas.py:75

    def kern(keys_ref, q_ref, out_ref):  # :77-91
        q = q_ref[:]
        keys = keys_ref[:]
        lo = jnp.zeros_like(q)
        hi = jnp.full_like(q, T)

        def body(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            kv = jnp.take(keys, mid, axis=0)
            go_right = kv < q
            return (jnp.where(go_right, mid + 1, lo),
                    jnp.where(go_right, hi, mid))

        lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
        out_ref[:] = lo

    return kern


def _bs_lane_kernel(T):
    steps = int(np.ceil(np.log2(T)))  # tools/micro_pallas2.py:100

    def kern(t_ref, q_ref, o_ref):  # :102-115
        q = q_ref[:]
        lo = jnp.zeros_like(q)
        hi = jnp.full_like(q, T)

        def body(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            kv = jnp.take_along_axis(t_ref[:], mid, axis=0)
            right = kv < q
            return jnp.where(right, mid + 1, lo), jnp.where(right, hi, mid)

        lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
        o_ref[:] = lo

    return kern


def _queries_with_band(rng, keys, n):
    """Random queries over the key range, with the band keys[0] < q <=
    keys[1] and its edges written into the first ones."""
    q = rng.integers(0, 2**30, n).astype(np.int32)
    k0, k1 = int(keys[0]), int(keys[1])
    q[:6] = [k0, k0 + 1, (k0 + k1) // 2 + 1, k1, k1 + 1, keys[-1]]
    return q


def _check_band(got, keys, q):
    """The TPU body equals searchsorted except on keys[0] < q <= keys[1],
    where it gives 0 and the port 1."""
    ref = MK.lower_bound_plain(_t(keys), _t(q)).numpy()
    np.testing.assert_array_equal(ref, np.searchsorted(keys, q))
    band = (q > keys[0]) & (q <= keys[1])
    assert band.sum() >= 3
    np.testing.assert_array_equal(got[~band], ref[~band])
    assert (got[band] == 0).all() and (ref[band] == 1).all()


def test_lower_bound_plain_vs_tpu_bsearch():
    """T2 (tools/micro_pallas.py:93-104), 1,024 keys, tiles of 1,024."""
    rng = np.random.default_rng(2)
    T, Q, tile = 1024, 4096, 1024
    keys = np.sort(rng.integers(0, 2**30, T)).astype(np.int32)
    q = _queries_with_band(rng, keys, Q)
    got = np.asarray(pl.pallas_call(
        _bsearch_kernel(T),
        out_shape=jax.ShapeDtypeStruct((Q,), jnp.int32),
        grid=(Q // tile,),
        in_specs=[VMEM((T,), lambda i: (0,)), VMEM((tile,), lambda i: (i,))],
        out_specs=VMEM((tile,), lambda i: (i,)),
        interpret=True,
    )(jnp.asarray(keys), jnp.asarray(q)))
    _check_band(got, keys, q)


def test_lower_bound_plain_vs_tpu_lane_bsearch():
    """T6 (tools/micro_pallas2.py:117-128): keys replicated over 128 lanes,
    queries (rows, 128) in blocks of 8 rows; the port searches column 0."""
    rng = np.random.default_rng(3)
    T, rows, blk = 256, 16, 8
    keys = np.sort(rng.integers(0, 2**30, T)).astype(np.int32)
    keys_rep = np.broadcast_to(keys[:, None], (T, 128)).copy()
    q = _queries_with_band(rng, keys, rows * 128).reshape(rows, 128)
    got = np.asarray(pl.pallas_call(
        _bs_lane_kernel(T),
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
        grid=(rows // blk,),
        in_specs=[VMEM((T, 128), lambda i: (0, 0)),
                  VMEM((blk, 128), lambda i: (i, 0))],
        out_specs=VMEM((blk, 128), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(keys_rep), jnp.asarray(q)))
    _check_band(got, keys, q)


def _lane_call(op, idx, S, blocks):
    """tools/micro_lanegather.py:30-41 (micro_lanegather2.py:26-37): block b
    of S rows of op and idx per grid step."""
    return np.asarray(pl.pallas_call(
        _tala,
        out_shape=jax.ShapeDtypeStruct(idx.shape, op.dtype),
        grid=(blocks,),
        in_specs=[VMEM((S, 128), lambda b: (b, 0)),
                  VMEM((S, 128), lambda b: (b, 0))],
        out_specs=VMEM((S, 128), lambda b: (b, 0)),
        interpret=True,
    )(jnp.asarray(op), jnp.asarray(idx)))


def _check_lane(got, op, idx, S, stride):
    ref = MK.lane_gather_plain(_t(op), _t(idx), S, stride).numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype
    np.testing.assert_array_equal(ref.view(np.int32), got.view(np.int32))


def test_lane_gather_plain_matches_tpu_block_local():
    """T7 (tools/micro_lanegather.py), S = 16, 4 blocks."""
    S, NB = 16, 4
    rng = np.random.default_rng(4)
    op = rng.normal(size=(NB * S, 128)).astype(np.float32)
    idx = rng.integers(0, S, (NB * S, 128)).astype(np.int32)
    _check_lane(_lane_call(op, idx, S, NB), op, idx, S, S)


@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["f32", "i32"])
@pytest.mark.parametrize("S", [8, 32, 128, 256])
def test_lane_gather_plain_matches_tpu_sweep(S, dtype):
    """T8 (tools/micro_lanegather2.py) on the port's make_case, 2 blocks."""
    op, idx = MLG2.make_case(S, dtype, NB=2, seed=S)
    assert op.dtype == dtype and idx.max() < S
    _check_lane(_lane_call(op, idx, S, 2), op, idx, S, S)


def test_lane_gather_plain_matches_tpu_whole_table():
    """T5 (tools/micro_pallas2.py:71-82): the whole (T, 128) table resident,
    idx in blocks of 8 rows, one window (S = rows, stride 0)."""
    rng = np.random.default_rng(5)
    T, rows, blk = 64, 32, 8
    table = rng.normal(size=(T, 128)).astype(np.float32)
    idx = rng.integers(0, T, (rows, 128)).astype(np.int32)
    got = np.asarray(pl.pallas_call(
        _tala,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        grid=(rows // blk,),
        in_specs=[VMEM((T, 128), lambda i: (0, 0)),
                  VMEM((blk, 128), lambda i: (i, 0))],
        out_specs=VMEM((blk, 128), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(table), jnp.asarray(idx)))
    _check_lane(got, table, idx, rows, 0)


def test_lane_gather_plain_matches_tpu_take_along_axis():
    """T9 (tools/probe_tala.py:15-19) on the port's make_case, which draws
    the TPU probe's own arrays."""
    table, idx = PT.make_case()
    got = np.asarray(pl.pallas_call(
        _tala, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[VMEM(), VMEM()], out_specs=VMEM(), interpret=True,
    )(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, np.take_along_axis(table, idx, 0))
    _check_lane(got, table, idx, 8, 0)


def test_make_cases_match_tpu_probe_draws():
    """The ports' make_case draw the TPU probes' arrays in their order."""
    rng = np.random.default_rng(0)  # tools/micro_pallas.py:39-44, :73-74
    t1 = MP.make_case(T=64, Q=128, QR=32)
    np.testing.assert_array_equal(t1[0], rng.integers(0, 2**30, 64))
    np.testing.assert_array_equal(t1[1], rng.integers(0, 64, 128))
    np.testing.assert_array_equal(t1[2], np.sort(rng.integers(0, 2**30, 64)))
    t4 = MP2.make_case(T=64, Q=256)
    assert t4[0].shape == (64, 128) and t4[2].shape == t4[4].shape == (2, 128)
    assert (np.diff(t4[3]) >= 0).all()


# ---------------------------------------------------------------------------
# T11: the rowdense conv prototype
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpu_rowconv():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_pallas_rowconv", REPO / "tools" / "probe_pallas_rowconv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_level(tpu_rowconv):
    """The TPU probe's small case (:188-196), made by its own make_level."""
    key = jax.random.PRNGKey(0)
    _, R, X, density, shifts = RC.CASES[0]
    xs, feats = tpu_rowconv.make_level(key, R, RC.W, RC.C, X, density)
    w = jax.random.normal(key, (len(shifts) * 3, RC.C, RC.COUT),
                          jnp.float32) * 0.1
    ref = tpu_rowconv.ref_conv(xs, feats, w.astype(jnp.bfloat16), shifts,
                               RC.X_OFF, R, RC.W, RC.C, RC.COUT)
    ref = np.asarray(ref).reshape(R, -1)
    return xs, feats, w, shifts, ref


def _port_plain(xs, feats, w, shifts):
    return RC.rowconv_plain(
        _t(xs), _t(feats.astype(jnp.float32)).bfloat16(),
        _t(w).bfloat16(), shifts, RC.X_OFF).numpy()


def test_rowconv_plain_matches_ref_conv(small_level):
    """Shifts of up to 17 rows reach past both ends of the 512 rows; rows
    keep duplicate x values (the reference's dedupe is a no-op), and every
    duplicate match is summed."""
    xs, feats, w, shifts, ref = small_level
    xsn = np.asarray(xs)
    valid = xsn < RC.SENT
    assert ((xsn[:, 1:] == xsn[:, :-1]) & valid[:, 1:]).sum() > 0
    got = _port_plain(xs, feats, w, shifts)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= 1e-4 * scale
    assert (got.reshape(*xsn.shape, -1)[~valid] == 0).all()
    # matches by brute force: the useful work the probe's rate counts
    R = xsn.shape[0]
    n = 0
    for s in shifts:
        for r in range(max(0, -s), min(R, R - s)):
            d = xsn[r + s][None, :] - xsn[r][:, None]
            n += int((np.isin(d, RC.X_OFF) & valid[r][:, None]
                      & (xsn[r + s] < RC.SENT)[None, :]).sum())
    assert RC.count_matches(_t(xs), shifts, RC.X_OFF) == n


class _RepeatShim:
    """pltpu with ``repeat`` as jnp.repeat (each element n times), the
    im2col mask the prototype meant."""

    def __getattr__(self, name):
        return getattr(pltpu, name)

    @staticmethod
    def repeat(x, n, axis):
        return jnp.repeat(x, n, axis=axis)


def _pallas_conv(mod, xs, feats, w, shifts):
    R = xs.shape[0]
    return np.asarray(mod.pallas_conv(xs, feats, w, shifts, RC.X_OFF, RB=256,
                                      COUT=RC.COUT, interpret=True)
                      ).reshape(R, -1)


def test_rowconv_plain_matches_repaired_pallas_conv(tpu_rowconv, small_level,
                                                    monkeypatch):
    xs, feats, w, shifts, ref = small_level
    monkeypatch.setattr(tpu_rowconv, "pltpu", _RepeatShim())
    got = _pallas_conv(tpu_rowconv, xs, feats, w, shifts)
    port = _port_plain(xs, feats, w, shifts)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - port).max() <= 1e-2 * scale


def test_pallas_conv_tiled_mask_is_off(tpu_rowconv, small_level):
    """Reference caveat: pltpu.repeat tiles (jnp.tile), so the unpatched
    body's im2col is scrambled and misses its own 0.2 check."""
    xs, feats, w, shifts, ref = small_level
    got = _pallas_conv(tpu_rowconv, xs, feats, w, shifts)
    assert np.abs(got - ref).max() > 0.2


def test_make_level_distributions():
    R, X = 4096, 200
    xs, feats = RC.make_level(R, RC.W, RC.C, X, 4.0, seed=7)
    assert xs.shape == (R, RC.W) and xs.dtype == np.int32
    assert feats.shape == (R, RC.W * RC.C) and feats.dtype == np.float32
    valid = xs < RC.SENT
    counts = valid.sum(1)
    # valid slots first, ascending, in [0, X); Poisson(4) counts
    assert (valid[:, :-1] >= valid[:, 1:]).all()
    assert (np.diff(xs, axis=1) >= 0).all()
    assert xs[valid].min() >= 0 and xs[valid].max() < X
    assert abs(counts.mean() - 4.0) < 0.15
    f3 = feats.reshape(R, RC.W, RC.C)
    assert (f3[~valid] == 0).all() and (f3[valid] != 0).all()
    assert ((xs[:, 1:] == xs[:, :-1]) & valid[:, 1:]).any()


# ---------------------------------------------------------------------------
# the *_cuda wrappers take CUDA tensors only
# ---------------------------------------------------------------------------

def _cpu_calls():
    f = torch.zeros((8, 128), dtype=torch.float32)
    i = torch.zeros((8, 128), dtype=torch.int32)
    xs = torch.full((4, 16), RC.SENT, dtype=torch.int32)
    return {
        "gather_rows": (MK.KERNEL, lambda: MK.gather_rows_cuda(f, i[0])),
        "lower_bound": (MK.KERNEL, lambda: MK.lower_bound_cuda(i[0], i)),
        "lane_gather": (MK.KERNEL, lambda: MK.lane_gather_cuda(f, i, 8, 0)),
        "rowconv": (RC.KERNEL, lambda: RC.rowconv_cuda(
            xs, torch.zeros((4, 256), dtype=torch.bfloat16),
            torch.zeros((27, 16, 16), dtype=torch.bfloat16),
            RC.shifts_3x3(2), RC.X_OFF)),
    }


@pytest.mark.parametrize("name", ["gather_rows", "lower_bound", "lane_gather",
                                  "rowconv"])
def test_cuda_wrappers_raise_on_cpu(name):
    kernel, call = _cpu_calls()[name]
    before = dict(kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert kernel.launches == before
