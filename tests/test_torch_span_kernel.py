"""The CUDA span-conv kernel vs its plain PyTorch version (needs the card).

Every shape class of the inference path, at small sizes: the 5^3 stem
(T=10, cin=1) and the incremental mode's T=1 stem over one scan, the 2^3
stride-2 down convs with the occupancy part, the 3^4 blocks with cat parts
and t-pruned rectangular bands, the UNet's T=1
subm and stride-2/pad-1 convs, the z-only (1,1,3) conv_out, spans 192,
256 and 384, plus a narrow-span plan that forces coverage overflow.

Tolerances: float32 operands agree to 1e-4 (the kernel and cuBLAS sum the
same float32 products in different orders); bf16 operands are exact in
float32 products too, so the same tolerance holds relative to the output
scale.

Run on the card with:
    python -m pytest --noconftest -m gpu tests/test_torch_span_kernel.py
(--noconftest: the repository's conftest imports jax, which the GPU
machine does not have).
"""

import numpy as np
import pytest
import torch

from insmos_tpu_torch import obs
from insmos_tpu_torch.sparse import slab as S
from insmos_tpu_torch.sparse import span_conv as SC

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slab(rng, dev, n, dims, T, cin, cap):
    c3 = np.stack([rng.integers(0, e, n) for e in dims], -1).astype(np.int32)
    tc = rng.integers(0, T, n).astype(np.int32)
    slab, _, _, nd = S.build_slab(
        torch.from_numpy(c3).to(dev), torch.from_numpy(tc).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev), dims, T, cap,
    )
    f = torch.from_numpy(rng.normal(size=(cap, T * cin)).astype(np.float32))
    slab = slab.replace_feats(f.to(dev))
    return slab.replace_feats(slab.mask_feats())


# name, dims, T, kernel4, conv kind, span, slots/gwin/pairs/bs
CASES = [
    ("stem", (64, 48, 16), 10, (5, 5, 5, 1), "subm", 256, (512, 16, 256)),
    # the incremental mode's T=1 stem over one scan's slab, at its literal
    # budgets (nn/minkunet4d.py PLAN_BUDGETS["stem_scan"])
    ("stem_scan", (96, 80, 20), 1, (5, 5, 5, 1), "subm", 192,
     (3072, 40, 2560)),
    ("down_occ", (64, 48, 16), 10, (2, 2, 2, 1), "down", 256, (256, 8, 256)),
    ("block_cat_tprune", (48, 40, 12), 6, (3, 3, 3, 3), "cat", 192,
     (256, 16, 256)),
    ("unet_subm", (96, 80, 20), 1, (3, 3, 3, 1), "subm", 192, (256, 16, 256)),
    ("unet_s2p1", (96, 80, 20), 1, (3, 3, 3, 1), "s2p1", 256, (256, 12, 256)),
    ("conv_out", (24, 20, 5), 1, (1, 1, 3, 1), "zout", 384, (128, 8, 256)),
    ("block_384", (32, 24, 8), 4, (3, 3, 3, 3), "subm", 384, (128, 8, 128)),
    ("narrow_overflow", (48, 40, 12), 3, (3, 3, 3, 3), "subm", 32,
     (8, 2, 8, 64)),
]


def _launches():
    c = obs.counters()
    return (c.get("span_conv.launches", 0),
            c.get("span_conv.slot_launches", 0))


def _run_case(case, dev, dtype, seed=0):
    name, dims, T, kernel, kind, span, budget = case
    slots, gwin, pairs, bs = budget + (128,) * (4 - len(budget))
    rng = np.random.default_rng(seed)
    cin, cout = (1, 8) if name.startswith("stem") else (6, 5)
    x = _slab(rng, dev, 3000, dims, T, cin, 4096)
    k3 = kernel[:3]
    stride, pad, out, odims = (1, 1, 1), None, x, dims
    if kind in ("down", "s2p1", "zout"):
        stride = {"down": (2, 2, 2), "s2p1": (2, 2, 2), "zout": (1, 1, 2)}[kind]
        pad = (1, 1, 1) if kind == "s2p1" else (0, 0, 0)
        odims = tuple(-(-d // s) for d, s in zip(dims, stride))
        if kind == "zout":
            odims = (dims[0], dims[1], (dims[2] - 3) // 2 + 1)
        out, _, _ = S.derive_strided_sites(x, k3, stride, pad, odims, 4096)
    plan = SC.make_span_plan(
        x.keys, out.coords, out.valid, k3, stride3=stride, pad3=pad,
        in_dims=dims, span=span, slots=slots, gwin=gwin, pairs=pairs, bs=bs,
    )
    K = int(np.prod(kernel))
    gen = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(dev).to(dtype)
    if kind == "down":
        weights = [gen(K, cin, cout), torch.ones((K, 1, 1), dtype=dtype,
                                                 device=dev)]
        occf = x.occ.to(torch.float32)
        feats = torch.cat([x.mask_feats(), occf], -1)
        parts = (SC.ConvPart(cin, cout, T, 1, 0, 0),
                 SC.ConvPart(1, 1, T, 1, T * cin, T * cout))
        T_out = T
    elif kind == "cat":
        cb = 3
        fb = torch.from_numpy(
            rng.normal(size=(4096, T * cb)).astype(np.float32)).to(dev)
        feats = torch.cat([x.mask_feats(), x.replace_feats(fb).mask_feats()],
                          -1)
        t0 = 2
        T_out = T - t0
        weights = [gen(K, cin, cout), gen(K, cb, cout)]
        parts = (SC.ConvPart(cin, cout, T, 3, 0, 0, t0),
                 SC.ConvPart(cb, cout, T, 3, T * cin, 0, t0))
    else:
        kt = kernel[3]
        weights = [gen(K, cin, cout)]
        parts = (SC.ConvPart(cin, cout, T, kt, 0, 0, 0),)
        feats = x.mask_feats()
        T_out = T
    args = (x.keys, feats, weights, parts, out.coords, out.valid, plan, T_out)
    before = _launches()
    got = SC.span_conv_parts(*args)
    if got.is_cuda:
        torch.cuda.synchronize()
    ref = SC.span_conv_parts_plain(*args)
    after = _launches()
    return got, ref, plan, before, after


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(case, dtype, cuda):
    got, ref, plan, before, after = _run_case(case, cuda, dtype)
    assert after[0] == before[0] + 1
    assert after[1] == before[1] + (1 if plan.gs.shape[1] else 0)
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * scale, (case[0], err, scale)
    if case[0] == "narrow_overflow":
        assert int(plan.n_overflow) > 0 and plan.gs.shape[1] > 0


# Main-path widths at the kernel's own interface: (TC, TO, kx). Every TC,
# TO and kx of the full-config step appears at least once; the TO = 320
# cases run two column tiles. Each plan has live coverage slots, n_overflow
# > 0 and dead blocks; about half of the (k16, n8) weight tiles are zero, as
# the t-band leaves them.
# Tolerance 5e-4 x max(1, |plain|): the bf16 products are exact in float32
# on both sides, summed in another order (per group on the tensor cores,
# up to 90 k16 steps, then across groups on the CUDA cores).
WIDE = [(10, 96, 5), (10, 8, 2), (60, 8, 3), (80, 160, 3), (128, 320, 3),
        (336, 96, 2), (480, 320, 3), (128, 8, 2), (60, 160, 5)]


def _wide_case(TC, TO, kx, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dims, n, cap, bs = (96, 40, 12), 5000, 6144, 128
    x = _slab(rng, dev, n, dims, 1, 1, cap)
    valid = x.valid.clone()
    valid[2 * bs:4 * bs] = False  # two dead output blocks
    plan = SC.make_span_plan(
        x.keys, x.coords, valid, (kx, 3, 3), in_dims=dims, span=128,
        slots=512, gwin=6, pairs=160, bs=bs)
    feats = torch.from_numpy(rng.normal(size=(cap, TC)).astype(np.float32))
    w = rng.normal(size=(9, kx * TC, TO)).astype(np.float32) * 0.1
    Kp = -(-kx * TC // 16) * 16
    tiles = rng.random((9, Kp // 16, -(-TO // 8))) < 0.5
    keep = np.repeat(np.repeat(tiles, 16, 1), 8, 2)[:, :kx * TC, :TO]
    wg = torch.from_numpy(w * keep)
    return (x.keys, feats.to(dev).to(dtype), wg.to(dev).to(dtype), x.coords,
            valid, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WIDE,
                         ids=[f"TC{a}_TO{b}_kx{c}" for a, b, c in WIDE])
def test_kernel_main_path_widths(shape, dtype, cuda):
    args = _wide_case(*shape, cuda, dtype)
    plan = args[-1]
    assert int(plan.n_overflow) > 0 and int((plan.gs[1] >= 0).sum()) > 0
    before = obs.counters()
    got = SC.span_conv_core_cuda(*args)
    torch.cuda.synchronize()
    assert obs.since(before)["span_conv.launches"] == 1
    ref = SC.span_conv_core_plain(*args)
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= 5e-4 * scale, (shape, err, scale)
    dead = ~args[4][: got.shape[0]]
    assert not got[dead].any()
