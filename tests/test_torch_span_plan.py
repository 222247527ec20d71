"""Span plan and site derivation: the port against the JAX package.

Every array here is integer (or boolean), so the comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insmos_tpu.sparse import convs as jconvs
from insmos_tpu.sparse import slab as js
from insmos_tpu.sparse import span_conv as jsc
from insmos_tpu.sparse.tensor import SparseTensor as JSparse
from insmos_tpu_torch.sparse import convs as tconvs
from insmos_tpu_torch.sparse import slab as ts
from insmos_tpu_torch.sparse import span_conv as tsc
from insmos_tpu_torch.sparse.tensor import SparseTensor as TSparse

from torch_port_common import hdl64_crop_stream


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _points(rng, n, dims, T):
    c3 = np.stack([rng.integers(0, d, n) for d in dims], -1).astype(np.int32)
    return c3, rng.integers(0, T, n).astype(np.int32)


def _both_slabs(c3, tc, dims, T, cap, valid=None):
    n = len(c3)
    v = np.ones(n, bool) if valid is None else valid
    j = js.build_slab(jnp.asarray(c3), jnp.asarray(tc), jnp.asarray(v), dims,
                      T, cap)
    t = ts.build_slab(torch.from_numpy(c3), torch.from_numpy(tc),
                      torch.from_numpy(v), dims, T, cap)
    return j, t


def _cmp_slab(jsl, tsl):
    for f in ("keys", "coords", "occ", "valid"):
        _eq(getattr(jsl, f), getattr(tsl, f), f)


def _hdl_crop_coords(T=2, seed=0):
    """Voxel coords of a cropped HDL-64E window (0.1 m voxels)."""
    scans, _, _ = hdl64_crop_stream(T, seed=seed, max_points=3072)
    c3 = np.concatenate([np.floor((s[:, :3] + [6.6, 6.6, 3.0]) * 10.0)
                         for s in scans]).astype(np.int32)
    tc = np.concatenate([np.full(len(s), t, np.int32)
                         for t, s in enumerate(scans)])
    return c3, tc, (132, 132, 50)


@pytest.mark.parametrize("seed,n,cap", [(0, 600, 1024), (1, 3000, 512),
                                        (2, 50, 64)])
def test_build_slab(seed, n, cap):
    rng = np.random.default_rng(seed)
    dims, T = (20, 16, 12), 4
    c3, tc = _points(rng, n, dims, T)
    c3[::7] -= 3  # some out-of-grid points
    valid = rng.random(n) > 0.1
    (jsl, jp, jn, jd), (tsl, tp, tn, td) = _both_slabs(c3, tc, dims, T, cap,
                                                       valid)
    _cmp_slab(jsl, tsl)
    _eq(jp, tp, "p2slot")
    assert int(jn) == int(tn) and int(jd) == int(td)


@pytest.mark.parametrize("kernel,stride,pad", [((2, 2, 2), (2, 2, 2),
                                                (0, 0, 0)),
                                               ((3, 3, 3), (2, 2, 2),
                                                (1, 1, 1))])
def test_derive_strided_sites(kernel, stride, pad):
    rng = np.random.default_rng(3)
    dims, T = (24, 20, 10), 2
    c3, tc = _points(rng, 900, dims, T)
    (jsl, *_), (tsl, *_) = _both_slabs(c3, tc, dims, T, 1024)
    odims = tuple(-(-d // s) for d, s in zip(dims, stride))
    for cap in (1024, 100):  # the second overflows
        jo, jn, jd = js.derive_strided_sites(jsl, kernel, stride, pad, odims,
                                             cap)
        to, tn, td = ts.derive_strided_sites(tsl, kernel, stride, pad, odims,
                                             cap)
        _cmp_slab(jo, to)
        assert (int(jn), int(jd)) == (int(tn), int(td))


def test_strided_occ_matches_window_tables():
    rng = np.random.default_rng(4)
    dims, T = (24, 20, 10), 3
    c3, tc = _points(rng, 700, dims, T)
    (jsl, *_), (tsl, *_) = _both_slabs(c3, tc, dims, T, 1024)
    odims = tuple(-(-d // 2) for d in dims)
    jo, _, _ = js.derive_strided_sites(jsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       odims, 512)
    to, _, _ = ts.derive_strided_sites(tsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       odims, 512)
    tbl = js.window_tables(js.site_grid(jsl), dims, jo.coords, jo.valid,
                           (2, 2, 2), stride3=(2, 2, 2), pad3=(0, 0, 0),
                           vin=jsl.capacity)
    ttbl = ts.window_tables(ts.site_grid(tsl), dims, to.coords, to.valid,
                            (2, 2, 2), stride3=(2, 2, 2), pad3=(0, 0, 0),
                            vin=tsl.capacity)
    _eq(js.strided_occ(jsl, tbl, jo).occ, ts.strided_occ(tsl, ttbl, to).occ,
        "occ")


@pytest.mark.parametrize("reach", [1, 2])
def test_dilate_and_compact(reach):
    rng = np.random.default_rng(5)
    dims, T = (30, 22, 9), 2
    c3, tc = _points(rng, 800, dims, T)
    (jsl, *_), (tsl, *_) = _both_slabs(c3, tc, dims, T, 1024)
    sel = rng.random(1024) < 0.05
    jm = js.dilate_mask(jsl.keys, jsl.valid & jnp.asarray(sel), dims, reach,
                        jsl.keys, jsl.valid)
    tm = ts.dilate_mask(tsl.keys, tsl.valid & torch.from_numpy(sel), dims,
                        reach, tsl.keys, tsl.valid)
    _eq(jm, tm, "dilate")
    for cap in (1024, 37):
        ji, jo = js.compact_rows(jm, cap)
        ti, to = ts.compact_rows(tm, cap)
        _eq(ji, ti, "compact")
        assert int(jo) == int(to)


def test_site_grid_and_parent_index():
    rng = np.random.default_rng(6)
    dims, T = (16, 14, 8), 2
    c3, tc = _points(rng, 500, dims, T)
    (jsl, *_), (tsl, *_) = _both_slabs(c3, tc, dims, T, 512)
    odims = tuple(-(-d // 2) for d in dims)
    jo, _, _ = js.derive_strided_sites(jsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       odims, 512)
    to, _, _ = ts.derive_strided_sites(tsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       odims, 512)
    _eq(js.site_grid(jo), ts.site_grid(to), "grid")
    _eq(js.parent_index(js.site_grid(jo), odims, jsl),
        ts.parent_index(ts.site_grid(to), odims, tsl), "parent")


def _sparse_pair(rng, n, dims, cap):
    c3, _ = _points(rng, n, dims, 1)
    from insmos_tpu.sparse.voxelize import unique_voxels as ju
    from insmos_tpu_torch.sparse.voxelize import unique_voxels as tu

    jsit, *_ = ju(jnp.asarray(c3), dims, cap)
    tsit, *_ = tu(torch.from_numpy(c3), dims, cap)
    f = rng.normal(size=(cap, 5)).astype(np.float32)
    return (JSparse(jsit.coords, jsit.keys, jnp.asarray(f), jsit.valid, dims),
            TSparse(tsit.coords, tsit.keys, torch.from_numpy(f), tsit.valid,
                    dims))


@pytest.mark.parametrize("kernel,stride,pad", [((3, 3, 3), (2, 2, 2),
                                                (1, 1, 1)),
                                               ((1, 1, 3), (1, 1, 2),
                                                (0, 0, 0))])
def test_strided_conv_sites_and_inverse_pairs(kernel, stride, pad):
    rng = np.random.default_rng(7)
    dims = (24, 18, 10)
    jx, tx = _sparse_pair(rng, 700, dims, 1024)
    odims = tuple(-(-d // s) for d, s in zip(dims, stride))
    if kernel == (1, 1, 3):
        odims = (dims[0], dims[1], (dims[2] - 3) // 2 + 1)
    js_, jp, jk = jconvs.strided_conv_sites(jx, kernel, stride, pad, odims,
                                            1024, with_pairs=True)
    ts_, tp, tk = tconvs.strided_conv_sites(tx, kernel, stride, pad, odims,
                                            1024, with_pairs=True)
    for f in ("keys", "coords", "valid"):
        _eq(getattr(js_, f), getattr(ts_, f), f)
    _eq(jp, tp, "pairs")
    _eq(jk, tk, "kidx")
    # inverse conv by pair replay (float: summation order only)
    K = int(np.prod(kernel))
    w = rng.normal(size=(K, 5, 4)).astype(np.float32)
    cf = rng.normal(size=(1024, 5)).astype(np.float32)
    jc = js_.replace_feats(jnp.asarray(cf))
    tc = ts_.replace_feats(torch.from_numpy(cf))
    ji = jconvs.inverse_conv_pairs(jc, jnp.asarray(w), jx.sites(), jp, jk,
                                   kernel_size=kernel, stride=stride, pad=pad)
    ti = tconvs.inverse_conv_pairs(tc, torch.from_numpy(w), tx.sites(), tp,
                                   tk, kernel, stride, pad)
    np.testing.assert_allclose(np.asarray(ji.feats), ti.feats.numpy(),
                               atol=1e-5, rtol=1e-5)


def _cmp_plan(jp, tp):
    for f in ("sb", "se", "emp", "gp", "gs", "n_overflow"):
        _eq(getattr(jp, f), getattr(tp, f), f)


PLAN_CASES = [
    # seed, dims, n, T, kernel3, strided, bs, span, slots, gwin, pairs
    (0, (32, 28, 8), 3000, 3, (3, 3, 3), False, 64, 128, 16, 2, None),
    (1, (48, 40, 12), 6000, 2, (3, 3, 3), False, 128, 256, 16, 6, None),
    (2, (20, 18, 14), 1500, 4, (5, 5, 5), False, 64, 192, 16, 3, None),
    (3, (40, 30, 10), 4000, 3, (2, 2, 2), True, 64, 64, 24, 4, None),
    (4, (64, 20, 6), 2500, 2, (3, 3, 3), False, 32, 32, 24, 9, 8),
    (5, (80, 12, 4), 1200, 3, (3, 3, 3), False, 128, 384, 0, 12, None),
]


@pytest.mark.parametrize(
    "seed,dims,n,T,kernel3,strided,bs,span,slots,gwin,pairs", PLAN_CASES)
def test_span_plan_random(seed, dims, n, T, kernel3, strided, bs, span,
                          slots, gwin, pairs):
    rng = np.random.default_rng(seed)
    cap = 1 << int(np.ceil(np.log2(n)))
    c3, tc = _points(rng, n, dims, T)
    (jsl, *_), (tsl, *_) = _both_slabs(c3, tc, dims, T, cap)
    stride, pad = ((2, 2, 2), (0, 0, 0)) if strided else ((1, 1, 1), None)
    jo, to = jsl, tsl
    if strided:
        od = tuple(-(-d // 2) for d in dims)
        jo, _, _ = js.derive_strided_sites(jsl, kernel3, stride, pad, od, cap)
        to, _, _ = ts.derive_strided_sites(tsl, kernel3, stride, pad, od, cap)
    kw = dict(stride3=stride, pad3=pad, in_dims=dims, bs=bs, span=span,
              slots=slots, gwin=gwin, pairs=pairs)
    jp = jsc.make_span_plan(jsl.keys, jo.coords, jo.valid, kernel3, **kw)
    tp = tsc.make_span_plan(tsl.keys, to.coords, to.valid, kernel3, **kw)
    _cmp_plan(jp, tp)
    # the exact uncovered-row counter (tools) agrees too
    je = jsc.make_span_plan(jsl.keys, jo.coords, jo.valid, kernel3,
                            exact_stats=True, **kw)
    te = tsc.make_span_plan(tsl.keys, to.coords, to.valid, kernel3,
                            exact_stats=True, **kw)
    assert int(je.n_overflow) == int(te.n_overflow)


def test_span_plan_tier2_pair_cap():
    """More pairs stay uncovered after the tier-1 rounds than the tier-2
    pair budget max(256, pairs // 4) holds: the pairs past it keep their
    tier-1 coverage and count into n_overflow. Output sites one per (y, z)
    row over a half-dense input grid make every block span 16 rows."""
    rng = np.random.default_rng(20)
    dims = (64, 256, 4)
    X, Y, Z = dims
    grid = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                                indexing="ij"), -1).reshape(-1, 3)
    c_in = grid[rng.random(len(grid)) < 0.5].astype(np.int32)
    yz = np.stack(np.meshgrid(np.arange(Y), np.arange(Z), indexing="ij"),
                  -1).reshape(-1, 2)
    c_out = np.concatenate([rng.integers(0, X, (len(yz), 1)), yz],
                           1).astype(np.int32)
    (ji, *_), (ti, *_) = _both_slabs(c_in, np.zeros(len(c_in), np.int32),
                                     dims, 1, 32768)
    (jo, *_), (to, *_) = _both_slabs(c_out, np.zeros(len(c_out), np.int32),
                                     dims, 1, 1024)
    kw = dict(in_dims=dims, bs=16, span=32, slots=4096, gwin=8, pairs=1024)
    jp = jsc.make_span_plan(ji.keys, jo.coords, jo.valid, (3, 3, 3), **kw)
    tp = tsc.make_span_plan(ti.keys, to.coords, to.valid, (3, 3, 3), **kw)
    _cmp_plan(jp, tp)
    assert int(tp.n_overflow) > 0


def test_span_plans_batched_hdl64_crop():
    """make_span_plans over one key array with the MotionNet L1 request mix
    (block / down / stem), on a crop of the HDL-64E fixture."""
    c3, tc, dims = _hdl_crop_coords()
    T = 2
    (jsl, *_), (tsl, *_) = _both_slabs(c3, tc, dims, T, 16384)
    od = tuple(-(-d // 2) for d in dims)
    jo, _, _ = js.derive_strided_sites(jsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       od, 8192)
    to, _, _ = ts.derive_strided_sites(tsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       od, 8192)

    def reqs(sl, o):
        return [
            dict(out_coords=sl.coords, out_valid=sl.valid, kernel3=(3, 3, 3),
                 in_dims=dims, bs=128, span=192, slots=256, gwin=12,
                 pairs=256),
            dict(out_coords=o.coords, out_valid=o.valid, kernel3=(2, 2, 2),
                 stride3=(2, 2, 2), pad3=(0, 0, 0), in_dims=dims, bs=128,
                 span=256, slots=128, gwin=8, pairs=128),
            dict(out_coords=sl.coords, out_valid=sl.valid, kernel3=(5, 5, 5),
                 in_dims=dims, span=256, slots=512, gwin=16, pairs=256),
        ]

    jps = jsc.make_span_plans(jsl.keys, reqs(jsl, jo))
    tps = tsc.make_span_plans(tsl.keys, reqs(tsl, to))
    assert any(p.gs.shape[1] and int((p.gs[1] >= 0).sum()) for p in tps)
    for jp, tp in zip(jps, tps):
        _cmp_plan(jp, tp)
