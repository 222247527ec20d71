"""The port's span-conv design probes (insmos_tpu_torch/tools) against the
TPU probes of tools/ on the CPU, at tiny sizes.

tools/probe_extract.py is loaded from its file (it runs nothing at import);
its Pallas bodies kern_A/B/C run in interpret mode with run_case.make's grid
spec rebuilt here, and tools/probe_dotshapes.py's kernel body (nested in its
main) is rebuilt here the same way. Tolerances: 1e-5 x max(1, max|ref|) for
the probes (both sides sum exact float32 products of bf16 operands, in
another order); atol = rtol = 1e-4 for span_conv_apply, as for the span
conv in tests/test_torch_span_conv.py.
"""

import dataclasses
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

from insmos_tpu.sparse import span_conv as jsc
from insmos_tpu_torch.sparse import span_conv as tsc
from insmos_tpu_torch.tools import probe_dotshapes as PD
from insmos_tpu_torch.tools import probe_extract as PE

REPO = Path(__file__).resolve().parents[1]
V, TCP, TOP, G, KX, BS = 512, 16, 16, 2, 3, 128


@pytest.fixture(scope="module")
def tpu_extract():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_extract", REPO / "tools" / "probe_extract.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("span", [64, 256])
def test_make_case_matches_tpu_probe(tpu_extract, span):
    jsb, jq0, jkeys2, jfeats, jwg = tpu_extract.make_case(V, TCP, TOP, span,
                                                          G, KX, BS)
    sb, q, keys, feats, wg = PE.make_case(V, TCP, TOP, span, G, KX, BS)
    np.testing.assert_array_equal(np.asarray(jsb), sb)
    np.testing.assert_array_equal(np.asarray(jfeats.astype(jnp.float32)),
                                  _bf16(feats))
    np.testing.assert_array_equal(np.asarray(jwg.astype(jnp.float32)),
                                  _bf16(wg))
    keys2 = np.asarray(jkeys2)
    assert keys2.shape[1] == span
    for r in range(keys2.shape[0]):
        np.testing.assert_array_equal(keys2[r], keys[r * 16:r * 16 + span])
    np.testing.assert_array_equal(
        np.asarray(jq0), np.broadcast_to(q.reshape(-1, 1, BS), jq0.shape))


def _tpu_run(mod, kern, span):
    """tools/probe_extract.py run_case.make (its :236-259) in interpret
    mode."""
    sb, q0, keys2, feats, wg = mod.make_case(V, TCP, TOP, span, G, KX, BS)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(V // BS,),
        in_specs=[
            pl.BlockSpec((1, 8, BS), lambda b, *_: (b, 0, 0)),
            pl.BlockSpec((G, KX * TCP, TOP), lambda b, *_: (0, 0, 0)),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((BS, TOP), lambda b, *_: (b, 0)),
        scratch_shapes=[
            pltpu.VMEM((2, 8, span), jnp.int32),
            pltpu.VMEM((2, span, TCP), jnp.bfloat16),
            pltpu.VMEM((BS, TOP), jnp.float32),
            pltpu.SemaphoreType.DMA((2, 2)),
        ],
    )
    k = functools.partial(kern, kx=KX, G=G, span=span, bs=BS)
    return np.asarray(pl.pallas_call(
        k, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((V, TOP), jnp.float32),
        interpret=True,
    )(sb, q0, wg, keys2, feats))


@pytest.mark.parametrize("span", [64, 256])
@pytest.mark.parametrize("variant", ["A", "B", "C"])
def test_extract_plain_matches_tpu_kernels(tpu_extract, variant, span):
    """Span 64 < bs: the window holds the taps of a quarter of the block's
    sites only, so out-of-window taps must count for nothing."""
    kern = getattr(tpu_extract, f"kern_{variant}")
    got = _tpu_run(tpu_extract, kern, span)
    args = PE.case_tensors(PE.make_case(V, TCP, TOP, span, G, KX, BS), "cpu")
    ref = PE.extract_plain(*args, kx=KX, span=span, bs=BS).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= 1e-5 * scale
    unrestricted = PE.extract_plain(*args, kx=KX, span=10**6, bs=BS).numpy()
    assert (span == 64) == (np.abs(unrestricted - ref).max() > 1e-3)


@pytest.mark.parametrize("V,span", [(512, 64), (512, 256), (500, 128)],
                         ids=["span64", "span256", "V500"])
def test_extract_gathered_matmul_matches_plain(V, span):
    """The one-call yardstick's operands: the taps gathered beforehand, by
    the stacked weights, give extract_plain's output (V = 500: the last
    block of bs = 128 is partial)."""
    args = PE.case_tensors(PE.make_case(V, TCP, TOP, span, G, KX, BS), "cpu")
    X, W = PE.extract_gathered(*args, kx=KX, span=span, bs=BS)
    assert X.shape == (V, G * KX * TCP) and X.dtype == torch.bfloat16
    assert W.shape == (G * KX * TCP, TOP) and W.dtype == torch.bfloat16
    ref = PE.extract_plain(*args, kx=KX, span=span, bs=BS)
    got = X.float() @ W.float()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert float(ref.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", ["without", "with"])
def test_span_conv_apply_matches_jax(slots, dtype):
    """A make_sites set on a small grid (16% occupied) with span 64 < bs, so
    every (block, group) pair needs coverage slots; "without" drops them as
    the production probe's variant D does."""
    dims, T, cin, cout = (40, 30, 8), 2, 4, 5
    keys, coords, valid, feats, w = PE.make_sites(1536, cin, cout, T, seed=3,
                                                  dims=dims)
    kw = dict(in_dims=dims, span=64, bs=128, slots=1024, gwin=16)
    ja = [jnp.asarray(a) for a in (keys, coords, valid, feats)]
    ta = [torch.from_numpy(a) for a in (keys, coords, valid, feats)]
    jp = jsc.make_span_plan(ja[0], ja[1], ja[2], (3, 3, 3), **kw)
    tp = tsc.make_span_plan(ta[0], ta[1], ta[2], (3, 3, 3), **kw)
    for f in ("sb", "se", "emp", "gp", "gs", "n_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)
    assert int((tp.gs[1] >= 0).sum()) > 0
    if slots == "without":
        jp = dataclasses.replace(jp, gs=jnp.zeros((4, 0), jnp.int32), js=0)
        tp = dataclasses.replace(tp, gs=torch.zeros((4, 0), dtype=torch.int32),
                                 js=0)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jout = jsc.span_conv_apply(ja[0], ja[3], ja[1], ja[2], jw, jp, T)
    tout = tsc.span_conv_apply(ta[0], ta[3], ta[1], ta[2], tw, tp, T)
    assert tout.shape == (1536, T * cout) and tout.dtype == torch.float32
    assert float(tout.abs().max()) > 0
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [(16, 32, 16, 1, False),
                                   (16, 32, 16, 3, False),
                                   (32, 64, 48, 1, False),
                                   (16, 32, 16, 3, True)],
                         ids=["16x32x16", "16x32x16_x3", "32x64x48",
                              "16x32x16_x3_splits"])
def test_dot_plain_matches_tpu_body(shape):
    """With ``split``, the sum is taken as the kernels take it at one copy
    on a 132-SM card: each split's partial over its reps (132 uneven ranges
    of the 192), then the partials added in split order."""
    M, K, N, n_dots, split = shape
    REP = PD.REP

    def kern(a_ref, b_ref, o_ref):  # tools/probe_dotshapes.py:28-37
        acc = jnp.zeros((M, N), jnp.float32)
        for r in range(REP):
            for d in range(n_dots):
                acc += jax.lax.dot_general(
                    a_ref[...], b_ref[...],
                    (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
        o_ref[...] = acc

    run = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    a, b = PD.make_operands(M, K, N)
    ref = np.asarray(run(jnp.asarray(a, jnp.bfloat16),
                         jnp.asarray(b, jnp.bfloat16)))
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    reps = REP * n_dots
    if split:
        S, ranges = PD.dot_splits(M, N, reps, 1, 132)
        assert S == 132 and reps % S
        got = torch.zeros((M, N))
        for r0, r1 in ranges:
            got += PD.dot_plain(ta, tb, r1 - r0)
        got = got.numpy()
    else:
        got = PD.dot_plain(ta, tb, reps).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= 1e-5 * scale


# M, N, reps, copies, sms
SPLIT_CASES = [(128, 128, 64, 1, 132), (128, 128, 192, 1, 132),
               (128, 384, 64, 1, 132), (512, 512, 64, 1, 132),
               (128, 128, 64, 132, 132), (128, 128, 64, 7, 132),
               (128, 128, 1, 1, 132), (256, 1024, 3, 1, 114),
               (128, 64, 64, 200, 132), (128, 128, 64, 65535, 132),
               (128, 128, 10**6, 1, 132)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=["x".join(map(str, c)) for c in SPLIT_CASES])
def test_dot_splits(case):
    M, N, reps, copies, sms = case
    S, ranges = PD.dot_splits(M, N, reps, copies, sms)
    assert len(ranges) == S and 1 <= S <= reps
    assert copies * S <= PD.MAX_GRID_Z
    # contiguous, in order, every rep in exactly one split, none empty
    assert ranges[0][0] == 0 and ranges[-1][1] == reps
    assert all(r0 < r1 for r0, r1 in ranges)
    assert all(p[1] == q[0] for p, q in zip(ranges, ranges[1:]))
    assert sorted(r for r0, r1 in ranges for r in range(r0, r1)) \
        == list(range(reps))
    assert max(r1 - r0 for r0, r1 in ranges) \
        - min(r1 - r0 for r0, r1 in ranges) <= 1
    blocks = PD.tiles(M, N) * copies
    if copies >= sms:
        assert S == 1
    elif S < min(reps, PD.MAX_GRID_Z // copies):
        # fills the card in one wave: one more split would not fit
        assert blocks * S <= sms < blocks * (S + 1)
    if 2 * blocks <= sms and reps > 1:
        assert S > 1


@pytest.mark.parametrize("variant", PE.VARIANTS)
def test_extract_cuda_raises_on_cpu(variant):
    args = PE.case_tensors(PE.make_case(V, TCP, TOP, 64, G, KX, BS), "cpu")
    before = dict(PE.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        PE.extract_cuda(*args, kx=KX, span=64, bs=BS, variant=variant)
    assert PE.KERNEL.launches == before


@pytest.mark.parametrize("variant", PD.VARIANTS)
def test_dot_cuda_raises_on_cpu(variant):
    a, b = (torch.from_numpy(x).bfloat16()
            for x in PD.make_operands(128, 32, 64))
    before = dict(PD.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        PD.dot_cuda(a, b, 2, variant)
    assert PD.KERNEL.launches == before
