"""The port's span conv (plain version, CPU) against the JAX package's
Pallas span kernels run in interpret mode, at every shape class of the
inference path.

Tolerance atol = rtol = 1e-4 in float32: both sides sum the same float32
products, in different orders (one-hot MXU extraction and fold on one
side, a direct gather and one matmul per group on the other)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insmos_tpu.sparse import slab as js
from insmos_tpu.sparse import span_conv as jsc
from insmos_tpu_torch import obs
from insmos_tpu_torch.sparse import slab as ts
from insmos_tpu_torch.sparse import span_conv as tsc

TOL = dict(atol=1e-4, rtol=1e-4)


def _slabs(rng, n, dims, T, cin, cap):
    c3 = np.stack([rng.integers(0, d, n) for d in dims], -1).astype(np.int32)
    tc = rng.integers(0, T, n).astype(np.int32)
    v = np.ones(n, bool)
    jsl, *_ = js.build_slab(jnp.asarray(c3), jnp.asarray(tc), jnp.asarray(v),
                            dims, T, cap)
    tsl, *_ = ts.build_slab(torch.from_numpy(c3), torch.from_numpy(tc),
                            torch.from_numpy(v), dims, T, cap)
    f = rng.normal(size=(cap, T * cin)).astype(np.float32)
    jsl = jsl.replace_feats(jnp.asarray(f))
    tsl = tsl.replace_feats(torch.from_numpy(f))
    return (jsl.replace_feats(jsl.mask_feats()),
            tsl.replace_feats(tsl.mask_feats()))


def _plans(jsl, tsl, jo, to, kernel3, **kw):
    jp = jsc.make_span_plan(jsl.keys, jo.coords, jo.valid, kernel3, **kw)
    tp = tsc.make_span_plan(tsl.keys, to.coords, to.valid, kernel3, **kw)
    return jp, tp


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# name, dims, T, cin, cout, kernel4, span, slots, gwin, bs
SUBM = [
    ("stem_5x5x5_T10_cin1", (16, 12, 10), 10, 1, 8, (5, 5, 5, 1), 256, None,
     12, 128),
    ("block_3x3x3x3", (16, 12, 10), 4, 5, 6, (3, 3, 3, 3), 192, None, 12, 128),
    ("unet_T1_subm", (20, 16, 12), 1, 6, 5, (3, 3, 3, 1), 192, None, 12, 128),
    ("span384", (16, 12, 8), 3, 4, 4, (3, 3, 3, 3), 384, None, 8, 128),
    ("slots_live", (24, 20, 10), 2, 4, 5, (3, 3, 3, 3), 64, 64, 8, 64),
    ("forced_overflow", (24, 20, 10), 2, 4, 5, (3, 3, 3, 3), 32, 8, 2, 32),
]


@pytest.mark.parametrize("case", SUBM, ids=[c[0] for c in SUBM])
def test_subm(case):
    name, dims, T, cin, cout, kernel, span, slots, gwin, bs = case
    rng = np.random.default_rng(SUBM.index(case))
    jsl, tsl = _slabs(rng, 700, dims, T, cin, 1024)
    jp, tp = _plans(jsl, tsl, jsl, tsl, kernel[:3], in_dims=dims, span=span,
                    slots=slots, gwin=gwin, bs=bs)
    if name == "slots_live":
        assert int(tp.n_overflow) == 0 and int((tp.gs[1] >= 0).sum()) > 0
    if name == "forced_overflow":
        assert int(tp.n_overflow) > 0
    w = (0.2 * rng.normal(size=(int(np.prod(kernel)), cin, cout))).astype(
        np.float32)
    jo = jp.conv(jsl, jnp.asarray(w), jsl, kernel)
    to = tp.conv(tsl, torch.from_numpy(w), tsl, kernel)
    _close(jo.feats, to.feats)


@pytest.mark.parametrize("T", [4, 10])
def test_down_with_occ(T):
    """(2,2,2) stride 2 pad 0 with the occupancy part (TC = T*cin + T)."""
    rng = np.random.default_rng(T)
    dims = (16, 12, 10)
    jsl, tsl = _slabs(rng, 600, dims, T, 3, 1024)
    od = tuple(-(-d // 2) for d in dims)
    jo, _, _ = js.derive_strided_sites(jsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       od, 512)
    to, _, _ = ts.derive_strided_sites(tsl, (2, 2, 2), (2, 2, 2), (0, 0, 0),
                                       od, 512)
    jp, tp = _plans(jsl, tsl, jo, to, (2, 2, 2), stride3=(2, 2, 2),
                    pad3=(0, 0, 0), in_dims=dims, span=256, slots=64, gwin=8)
    w = (0.3 * rng.normal(size=(8, 3, 4))).astype(np.float32)
    jr = jp.conv_with_occ(jsl, jnp.asarray(w), jo, (2, 2, 2, 1))
    tr = tp.conv_with_occ(tsl, torch.from_numpy(w), to, (2, 2, 2, 1))
    np.testing.assert_array_equal(np.asarray(jr.occ), tr.occ.numpy())
    _close(jr.feats, tr.feats)


@pytest.mark.parametrize("t0", [0, 1, 2])
def test_block_cat_t_pruned(t0):
    """3^4 conv over cat(a, b) with a rectangular t-band (t0_off > 0,
    T_out < T), as the decoder blocks run it."""
    rng = np.random.default_rng(10 + t0)
    dims, T = (16, 12, 10), 5
    ja, ta = _slabs(rng, 700, dims, T, 4, 1024)
    fb = rng.normal(size=(1024, T * 3)).astype(np.float32)
    jb = ja.replace_feats(jnp.asarray(fb))
    jb = jb.replace_feats(jb.mask_feats())
    tb = ta.replace_feats(torch.from_numpy(fb))
    tb = tb.replace_feats(tb.mask_feats())
    jp, tp = _plans(ja, ta, ja, ta, (3, 3, 3), in_dims=dims, span=192)
    w = (0.2 * rng.normal(size=(81, 7, 4))).astype(np.float32)
    jout = js.slice_slots(ja, t0, T - t0)
    tout = ts.slice_slots(ta, t0, T - t0)
    jr = jp.conv_cat(ja, jb, jnp.asarray(w), jout, (3, 3, 3, 3), t0_off=t0)
    tr = tp.conv_cat(ta, tb, torch.from_numpy(w), tout, (3, 3, 3, 3),
                     t0_off=t0)
    _close(jr.feats, tr.feats)


@pytest.mark.parametrize("geom", ["s2p1", "conv_out"])
def test_unet_strided(geom):
    """UNet T=1 stride-2 pad-1 (3,3,3) and the z-only (1,1,3) s(1,1,2)
    conv_out (kx = 1, G = 3)."""
    rng = np.random.default_rng(20)
    dims = (20, 16, 12)
    jsl, tsl = _slabs(rng, 800, dims, 1, 6, 1024)
    if geom == "s2p1":
        k3, s3, p3, span = (3, 3, 3), (2, 2, 2), (1, 1, 1), 256
        od = tuple(-(-d // 2) for d in dims)
    else:
        k3, s3, p3, span = (1, 1, 3), (1, 1, 2), (0, 0, 0), 384
        od = (dims[0], dims[1], (dims[2] - 3) // 2 + 1)
    jo, _, _ = js.derive_strided_sites(jsl, k3, s3, p3, od, 1024)
    to, _, _ = ts.derive_strided_sites(tsl, k3, s3, p3, od, 1024)
    jp, tp = _plans(jsl, tsl, jo, to, k3, stride3=s3, pad3=p3, in_dims=dims,
                    span=span, slots=128, gwin=8)
    w = (0.2 * rng.normal(size=(int(np.prod(k3)), 6, 5))).astype(np.float32)
    jr = jp.conv(jsl, jnp.asarray(w), jo, k3 + (1,))
    tr = tp.conv(tsl, torch.from_numpy(w), to, k3 + (1,))
    _close(jr.feats, tr.feats)


def test_plain_wrapper_is_the_cpu_path():
    """span_conv_parts on CPU tensors equals span_conv_parts_plain and
    launches no kernel."""
    rng = np.random.default_rng(30)
    dims = (16, 12, 10)
    _, tsl = _slabs(rng, 500, dims, 2, 3, 512)
    tp = tsc.make_span_plan(tsl.keys, tsl.coords, tsl.valid, (3, 3, 3),
                            in_dims=dims, span=64, slots=32, gwin=4, bs=64)
    w = torch.from_numpy((0.2 * rng.normal(size=(81, 3, 4))).astype(
        np.float32))
    part = (tsc.ConvPart(3, 4, 2, 3),)
    args = (tsl.keys, tsl.feats, [w], part, tsl.coords, tsl.valid, tp, 2)
    before = obs.counters()
    a = tsc.span_conv_parts(*args)
    b = tsc.span_conv_parts_plain(*args)
    assert torch.equal(a, b)
    moved = obs.since(before)
    assert (moved["span_conv.launches"],
            moved["span_conv.slot_launches"]) == (0, 0)
