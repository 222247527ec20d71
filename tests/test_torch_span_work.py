"""The span conv's work counter and the bf16 kernel's weight layout, on the
CPU.

``span_conv_work`` counts the matched (site, group, tap) triples, the useful
FLOPs and the bytes of one conv; it is held against a brute-force count over
the plan's windows on small random sets, with live coverage slots and with
forced overflow. ``mma_layout`` pads the folded weight for the tensor-core
kernel; cut back to the folded shape it must equal the folded weight
exactly, so the span conv through that layout equals the plain version bit
for bit."""

import numpy as np
import pytest
import torch

from insmos_tpu_torch import kernels
from insmos_tpu_torch.sparse import slab as S
from insmos_tpu_torch.sparse import span_conv as SC


def _slab(rng, n, dims, T, cin, cap):
    c3 = np.stack([rng.integers(0, d, n) for d in dims], -1).astype(np.int32)
    tc = rng.integers(0, T, n).astype(np.int32)
    sl, *_ = S.build_slab(torch.from_numpy(c3), torch.from_numpy(tc),
                          torch.ones(n, dtype=torch.bool), dims, T, cap)
    f = rng.normal(size=(cap, T * cin)).astype(np.float32)
    sl = sl.replace_feats(torch.from_numpy(f))
    return sl.replace_feats(sl.mask_feats())


def _brute_force(x_keys, out_coords, out_valid, plan, nnz):
    """(matched, flops) by walking every block, group, window, site and
    tap with a dict from key to input row."""
    row_of = {int(k): r for r, k in enumerate(x_keys.tolist())}
    X, Y, Z = plan.in_dims
    sx, sy, sz = plan.stride3
    px, py, pz = plan.pad3
    kx, bs, span = plan.kernel3[0], plan.bs, plan.span
    coords, valid = out_coords.numpy(), out_valid.numpy()
    gs = plan.gs.numpy()
    NB = -(-len(coords) // bs)
    matched = flops = 0
    for b in range(NB):
        sites = [i for i in range(b * bs, min((b + 1) * bs, len(coords)))
                 if valid[i]]
        for g, (ky, kz) in enumerate(plan.gp.tolist()):
            wins = []
            if sites and int(plan.emp[g, b]) == 0:
                s0 = int(plan.sb[g, b]) * 16
                wins.append((s0, s0 + span))
            for j in range(gs.shape[1]):
                if gs[1, j] == b and gs[0, j] == g:
                    wins.append((max(gs[2, j] * 16, gs[3, j]),
                                 gs[2, j] * 16 + span))
            for i in sites:
                ox, oy, oz = coords[i]
                iy, iz = oy * sy - py + ky, oz * sz - pz + kz
                if not (0 <= iy < Y and 0 <= iz < Z):
                    continue
                for d in range(kx):
                    xd = ox * sx - px + d
                    r = row_of.get((iz * Y + iy) * X + xd)
                    if (0 <= xd < X and r is not None
                            and any(lo <= r < hi for lo, hi in wins)):
                        matched += 1
                        flops += 2 * nnz[g][d]
    return matched, flops


# name, dims, T, cin, cout, kernel4, span, slots, gwin, bs
CASES = [
    ("block_3x3x3x3", (16, 12, 10), 4, 5, 6, (3, 3, 3, 3), 192, None, 12,
     128),
    ("slots_live", (24, 20, 10), 2, 4, 5, (3, 3, 3, 3), 64, 64, 8, 64),
    ("forced_overflow", (24, 20, 10), 2, 4, 5, (3, 3, 3, 3), 32, 8, 2, 32),
    ("stem_5x5x5", (16, 12, 10), 10, 1, 8, (5, 5, 5, 1), 256, None, 12, 128),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_span_conv_work_matches_brute_force(case):
    name, dims, T, cin, cout, kernel, span, slots, gwin, bs = case
    rng = np.random.default_rng(CASES.index(case))
    x = _slab(rng, 700, dims, T, cin, 1024)
    plan = SC.make_span_plan(x.keys, x.coords, x.valid, kernel[:3],
                             in_dims=dims, span=span, slots=slots, gwin=gwin,
                             bs=bs)
    if name == "slots_live":
        assert int(plan.n_overflow) == 0 and int((plan.gs[1] >= 0).sum()) > 0
    if name == "forced_overflow":
        assert int(plan.n_overflow) > 0
    w = torch.from_numpy(
        (0.2 * rng.normal(size=(int(np.prod(kernel)), cin, cout))).astype(
            np.float32))
    part = SC.ConvPart(cin, cout, T, kernel[3])
    feats, wg = SC._prepare(x.mask_feats(), [w], (part,), plan, T)
    work = SC.span_conv_work(x.keys, feats, wg, x.coords, x.valid, plan)
    G, K, TO = wg.shape
    kx, TC = kernel[0], feats.shape[1]
    nnz = (wg.reshape(G, kx, TC, TO) != 0).sum(dim=(2, 3)).tolist()
    assert (work["matched"], work["flops"]) == _brute_force(
        x.keys, x.coords, x.valid, plan, nnz)
    V, Vin = x.coords.shape[0], x.keys.shape[0]
    assert work["bytes"] == (4 * Vin + 4 * Vin * TC + 4 * G * K * TO
                             + 16 * V + 4 * V * TO)
    t_ops = work["flops"] / kernels.PEAK_BF16_FLOPS
    t_mem = work["bytes"] / kernels.PEAK_HBM_BYTES
    assert work["bound_ms"] == pytest.approx(max(t_ops, t_mem) * 1e3)
    assert work["bound_by"] == ("operations" if t_ops > t_mem else "bytes")
    if T >= 4 and kernel[3] == 3:  # a t-band of 3 leaves zeros from T = 4
        assert max(max(r) for r in nnz) < TC * TO


def _band_weight(rng, kx, G, parts, T_out, TO):
    ws = [torch.from_numpy((rng.normal(size=(kx * G * p.kt, p.cin, p.cout))
                            ).astype(np.float32)) for p in parts]
    TC = sum(p.T * p.cin for p in parts)
    return SC.fold_weights_parts(ws, parts, kx, G, T_out, torch.bfloat16,
                                 TC, TO)


# MotionNet block and decoder cat folds (t-band), a stem fold, odd widths
LAYOUTS = [
    ("block_T10_c8", lambda r: _band_weight(
        r, 3, 9, (SC.ConvPart(8, 8, 10, 3),), 10, 80)),
    ("cat_T10_320", lambda r: _band_weight(
        r, 3, 9, (SC.ConvPart(16, 32, 10, 3, 0, 0),
                  SC.ConvPart(32, 32, 10, 3, 160, 0)), 10, 320)),
    ("cat_tpruned_96", lambda r: _band_weight(
        r, 3, 9, (SC.ConvPart(4, 16, 10, 3, 0, 0, 2),
                  SC.ConvPart(2, 16, 10, 3, 40, 0, 2)), 6, 96)),
    ("stem_T10_c1", lambda r: _band_weight(
        r, 5, 25, (SC.ConvPart(1, 8, 10, 1),), 10, 80)),
    ("dense_odd", lambda r: torch.from_numpy(
        r.normal(size=(9, 3 * 7, 50)).astype(np.float32)).to(torch.bfloat16)),
]


@pytest.mark.parametrize("case", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_mma_layout_keeps_every_weight(case):
    rng = np.random.default_rng(LAYOUTS.index(case))
    wg = case[1](rng)
    G, K, TO = wg.shape
    wp, nw8, ntiles = SC.mma_layout(wg)
    N = 16 * nw8
    assert nw8 in SC.MMA_NW8 and N <= SC.MMA_N_MAX and ntiles * N >= TO
    assert ntiles == -(-TO // SC.MMA_N_MAX)
    assert nw8 == min(n for n in SC.MMA_NW8 if 16 * n * ntiles >= TO)
    assert wp.shape == (G, -(-K // 32) * 32, ntiles * N)
    assert wp.dtype == wg.dtype
    assert torch.equal(wp[:, :K, :TO], wg)
    assert not wp[:, K:].any() and not wp[:, :, TO:].any()
    if case[0].startswith(("block", "cat")):
        # the t-band leaves most (k16, n8) weight tiles of these folds zero;
        # the kernel multiplies them (skipping them cost more than it saved)
        tiles = (wp.view(G, -1, 16, ntiles, 2 * nw8, 8) != 0).any(5).any(2)
        assert float(tiles.float().mean()) < 0.7


def test_mma_layout_conv_matches_plain():
    """The span conv on the re-laid weight (cut back to (G, K, TO)) equals
    the plain version on the folded weight, bit for bit (slots live)."""
    rng = np.random.default_rng(7)
    dims, T = (24, 20, 10), 4
    x = _slab(rng, 700, dims, T, 4, 1024)
    plan = SC.make_span_plan(x.keys, x.coords, x.valid, (3, 3, 3),
                             in_dims=dims, span=64, slots=64, gwin=8, bs=64)
    assert int((plan.gs[1] >= 0).sum()) > 0
    w = torch.from_numpy(rng.normal(size=(81, 4, 6)).astype(np.float32))
    feats, wg = SC._prepare(x.mask_feats().to(torch.bfloat16),
                            [w.to(torch.bfloat16)],
                            (SC.ConvPart(4, 6, T, 3),), plan, T)
    wp, _, _ = SC.mma_layout(wg)
    G, K, TO = wg.shape
    core = (x.keys, feats)
    ref = SC.span_conv_core_plain(*core, wg, x.coords, x.valid, plan)
    got = SC.span_conv_core_plain(*core, wp[:, :K, :TO].contiguous(),
                                  x.coords, x.valid, plan)
    assert torch.equal(got, ref)


def test_cuda_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(3)
    x = _slab(rng, 300, (16, 12, 10), 2, 4, 512)
    plan = SC.make_span_plan(x.keys, x.coords, x.valid, (3, 3, 3),
                             in_dims=(16, 12, 10), span=192)
    wg = torch.zeros((9, 3 * 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        SC.span_conv_core_cuda(x.keys, x.feats.to(torch.bfloat16), wg,
                               x.coords, x.valid, plan)
