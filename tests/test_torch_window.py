"""The windowed sparse-conv engine (the training path's convs): the port's
slab.window_tables, window_conv with its custom backward, and strided_occ
against the JAX package's, on the same numpy inputs.

Tolerances: the tables and the occupancy are integers, compared exactly.
float32: the forward within 1e-5 * max(1, max|out|), each gradient (the
features' and the weight's, against jax.vjp) within 1e-4 * max(1, max|g|):
both sides sum the same float32 products in other orders. bf16: both sides
widen the same bf16 operands exactly and sum in float32, but both round the
gradients to bf16 at the end (the features' cotangent and dW, as the
reference's backward casts them), where a last-bit difference of the
float32 sums can flip a rounding: 1e-2 * max(1, max|x|), one bf16 step
(2^-8 relative) with margin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insmos_tpu.sparse import slab as js
from insmos_tpu_torch.sparse import slab as ts

import torch_port_common  # noqa: F401  (thread cap)

DIMS = (20, 18, 12)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}


def _slabs(seed, T, cap=1024, n=900):
    rng = np.random.default_rng(seed)
    c3 = np.stack([rng.integers(0, d, n) for d in DIMS], -1).astype(np.int32)
    tc = rng.integers(0, T, n).astype(np.int32)
    v = np.ones(n, bool)
    j = js.build_slab(jnp.asarray(c3), jnp.asarray(tc), jnp.asarray(v), DIMS,
                      T, cap)[0]
    t = ts.build_slab(torch.from_numpy(c3), torch.from_numpy(tc),
                      torch.from_numpy(v), DIMS, T, cap)[0]
    return j, t


def _with_feats(j, t, feats):
    jf = j.replace_feats(jnp.asarray(feats))
    jf = jf.replace_feats(jf.mask_feats())
    tf = t.replace_feats(torch.from_numpy(feats))
    return jf, tf.replace_feats(tf.mask_feats())


def _tables(jx, tx, jo, to, kernel3, stride3=(1, 1, 1), pad3=None):
    jt = js.window_tables(js.site_grid(jx), DIMS, jo.coords, jo.valid,
                          kernel3, stride3=stride3, pad3=pad3,
                          vin=jx.capacity)
    tt = ts.window_tables(ts.site_grid(tx), DIMS, to.coords, to.valid,
                          kernel3, stride3=stride3, pad3=pad3,
                          vin=tx.capacity)
    return jt, tt


def _strided_out(jx, tx):
    odims = tuple(-(-d // 2) for d in DIMS)
    jo = js.derive_strided_sites(jx, (2, 2, 2), (2, 2, 2), (0, 0, 0), odims,
                                 512)[0]
    to = ts.derive_strided_sites(tx, (2, 2, 2), (2, 2, 2), (0, 0, 0), odims,
                                 512)[0]
    return jo, to


@pytest.mark.parametrize("geom", ["stem", "subm", "strided"])
def test_window_tables_and_strided_occ_exact(geom):
    jx, tx = _slabs(1, T=3)
    kernel3 = {"stem": (5, 5, 5), "subm": (3, 3, 3), "strided": (2, 2, 2)}[
        geom]
    if geom == "strided":
        jo, to = _strided_out(jx, tx)
        jt, tt = _tables(jx, tx, jo, to, kernel3, (2, 2, 2), (0, 0, 0))
        np.testing.assert_array_equal(
            np.asarray(js.strided_occ(jx, jt, jo).occ),
            ts.strided_occ(tx, tt, to).occ.numpy())
    else:
        jt, tt = _tables(jx, tx, jx, tx, kernel3)
    assert tt.wstart.dtype == torch.int32 and tt.slotmap.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jt.wstart), tt.wstart.numpy())
    np.testing.assert_array_equal(np.asarray(jt.slotmap), tt.slotmap.numpy())
    assert (tt.kx, tt.vin) == (jt.kx, jt.vin)


CASES = {
    # name: (kernel, T, cin, cout, t0_off, strided)
    "stem 5^3x1": ((5, 5, 5, 1), 3, 1, 4, 0, False),
    "subm 3^4": ((3, 3, 3, 3), 3, 3, 4, 0, False),
    "subm 3^4 t0_off": ((3, 3, 3, 3), 3, 3, 4, 1, False),
    "strided 2^3": ((2, 2, 2, 1), 3, 3, 5, 0, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_window_conv_forward_and_vjp(case, chunk, dtype):
    kernel, T, cin, cout, t0_off, strided = CASES[case]
    rng = np.random.default_rng(7)
    jx, tx = _slabs(2, T)
    V = jx.capacity
    feats = rng.standard_normal((V, T * cin)).astype(np.float32)
    jx, tx = _with_feats(jx, tx, feats)
    if strided:
        jo, to = _strided_out(jx, tx)
        jt, tt = _tables(jx, tx, jo, to, kernel[:3], (2, 2, 2), (0, 0, 0))
        jo, to = js.strided_occ(jx, jt, jo), ts.strided_occ(tx, tt, to)
    else:
        jt, tt = _tables(jx, tx, jx, tx, kernel[:3])
        jo, to = jx, tx
        if t0_off:
            jo = js.slice_slots(jx, t0_off, T - t0_off)
            to = ts.slice_slots(tx, t0_off, T - t0_off)
    K = int(np.prod(kernel))
    w = (rng.standard_normal((K, cin, cout)) / np.sqrt(K * cin)).astype(
        np.float32)
    g = rng.standard_normal((to.capacity, to.T * cout)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def jfn(f, wt):
        x = jx.replace_feats(f)
        return js.window_conv(x, wt.astype(jdt), jt, jo, kernel, chunk=chunk,
                              t0_off=t0_off).feats

    jout, vjp = jax.vjp(jfn, jnp.asarray(jx.feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))

    tf = tx.feats.clone().requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tout = ts.window_conv(tx.replace_feats(tf), tw.to(tdt), tt, to, kernel,
                          chunk=chunk, t0_off=t0_off).feats
    (tout * torch.from_numpy(g)).sum().backward()

    ftol, gtol = TOL[dtype]
    for got, ref, tol, what in ((tout.detach(), jout, ftol, "out"),
                                (tf.grad, jdf, gtol, "dfeats"),
                                (tw.grad, jdw, gtol, "dweight")):
        ref = np.asarray(ref, np.float32)
        got = got.float().numpy()
        assert got.shape == ref.shape, what
        assert np.abs(ref).max() > 0, what
        err = np.abs(got - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), (what, err)


def test_window_conv_chunks_agree():
    """Chunked and unchunked runs of the port's engine: the same sums per
    output row (forward bit for bit; the weight gradient sums the chunks'
    partial products in another order)."""
    kernel, T, cin, cout = (3, 3, 3, 3), 3, 3, 4
    rng = np.random.default_rng(3)
    _, tx = _slabs(4, T)
    tx = tx.replace_feats(torch.from_numpy(rng.standard_normal(
        (tx.capacity, T * cin)).astype(np.float32)))
    tx = tx.replace_feats(tx.mask_feats())
    tt = ts.window_tables(ts.site_grid(tx), DIMS, tx.coords, tx.valid,
                          kernel[:3], vin=tx.capacity)
    w = torch.from_numpy(rng.standard_normal((81, cin, cout)).astype(
        np.float32))
    outs = []
    for chunk in (None, 128):
        wr = w.clone().requires_grad_(True)
        o = ts.window_conv(tx, wr, tt, tx, kernel, chunk=chunk).feats
        o.square().sum().backward()
        outs.append((o.detach(), wr.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-5)

