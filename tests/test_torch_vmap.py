"""The multi-stream pod's batched units under ``torch.func.vmap`` on the CPU.

The pod runs one step vmapped over a device's slots with vmap's per-slot
fallback off, so every op of the step needs a batching rule. Each unit here
runs vmapped over S in {1, 2, 3} slots, the fallback off, against the same
function slot by slot, and must equal it bit for bit: the window site set
(build_slab) and its fixed-frame maintenance (maintain_window_slab), the
strided site sets and the span plans (make_span_plans, the integers the
JAX plans are held to), the voxelizer (voxelize_points), the BEV
projection (to_dense_bev), the span conv op's batching rule (its plain
version slot by slot on the CPU) and the NMS op's (one device-to-host copy
for all slots). Slots differ in their point counts; the NMS has a slot with
no valid box. Last, an op with no batching rule inside the pod's step
raises instead of looping over slots, and the fallback is restored."""

import numpy as np
import pytest
import torch
from torch.utils import _pytree

from insmos_tpu_torch import obs
from insmos_tpu_torch.ops import nms as N
from insmos_tpu_torch.pipeline import PodInferencePipeline, no_vmap_fallback
from insmos_tpu_torch.sparse import slab as SL
from insmos_tpu_torch.sparse import span_conv as SC
from insmos_tpu_torch.sparse.bev import to_dense_bev
from insmos_tpu_torch.sparse.voxelize import voxelize_points
from insmos_tpu_torch.utils.params import init_params, make_model

from test_torch_model import port_config
from torch_port_common import hdl64_crop_stream, tiny_config

SLOTS = (1, 2, 3)
DIMS = (40, 32, 8)
W, C = 3, 4


def _vmapped(fn, *args):
    with torch.inference_mode(), no_vmap_fallback():
        return torch.func.vmap(fn)(*args)


def _per_slot(fn, *args):
    with torch.inference_mode():
        outs = [fn(*_pytree.tree_map(lambda t: t[s], args))
                for s in range(_pytree.tree_leaves(args)[0].shape[0])]
    return _pytree.tree_map(lambda *xs: torch.stack(xs), *outs)


def _assert_equal(fn, *args):
    got, ref = _vmapped(fn, *args), _per_slot(fn, *args)
    lg, sg = _pytree.tree_flatten(got)
    lr, sr = _pytree.tree_flatten(ref)
    assert sg == sr
    for i, (g, r) in enumerate(zip(lg, lr)):
        assert g.dtype == r.dtype and torch.equal(g, r), i
    return got


def _points(S, n, T, seed):
    """Per slot: integer coords on DIMS (a few off the grid), a t column
    and a valid mask with a slot-dependent point count."""
    rng = np.random.default_rng(seed)
    c3 = rng.integers(-1, np.array(DIMS) + 1, (S, n, 3)).astype(np.int32)
    c3[..., :2] //= 2  # dense enough to share sites
    t = rng.integers(0, T, (S, n)).astype(np.int32)
    valid = np.arange(n)[None] < (n - 97 * np.arange(S))[:, None]
    return (torch.from_numpy(c3), torch.from_numpy(t),
            torch.from_numpy(valid))


@pytest.mark.parametrize("S", SLOTS)
def test_build_slab(S):
    c3, t, valid = _points(S, 1500, W, S)
    out = _assert_equal(
        lambda c, tc, v: SL.build_slab(c, tc, v, DIMS, W, 600), c3, t, valid)
    assert (out[3] > 0).any()  # capacity drops in at least one slot


@pytest.mark.parametrize("S", SLOTS)
def test_maintain_window_slab(S):
    c3, t, valid = _points(S, 1500, W, 10 + S)
    n3, _, nvalid = _points(S, 400, 1, 20 + S)
    with torch.inference_mode():
        prev = _per_slot(lambda c, tc, v: SL.build_slab(c, tc, v, DIMS, W,
                                                        2048)[0], c3, t, valid)
        scan = _per_slot(lambda c, v: SL.build_slab(
            c, torch.zeros_like(v, dtype=torch.int32), v, DIMS, 1, 512)[0],
            n3, nvalid)
    rng = np.random.default_rng(S)
    stem = torch.from_numpy(rng.normal(size=(S, 2048, W * C)).astype(
        np.float32))
    shift = torch.from_numpy(rng.integers(-2, 3, (S, 3)).astype(np.int32))
    _assert_equal(
        lambda k, o, st, nk, nv, sh: SL.maintain_window_slab(
            k, o, st, nk, nv, sh, DIMS, W, C, 2048),
        prev.keys, prev.occ, stem, scan.keys, scan.valid, shift)


def _plans(keys, coords, valid, occ):
    """The block plan of a slab and the down plan onto its strided sites,
    from one key array, as a tuple of every plan tensor."""
    x = SL.Slab(keys, coords, occ, torch.zeros((keys.shape[0], 0)), valid,
                DIMS, W)
    nxt, n_s, n_d = SL.derive_strided_sites(x, (2, 2, 2), (2, 2, 2),
                                            (0, 0, 0), (20, 16, 4), 512)
    plans = SC.make_span_plans(keys, [
        dict(out_coords=coords, out_valid=valid, kernel3=(3, 3, 3),
             in_dims=DIMS, span=64, slots=256, gwin=8, pairs=128),
        dict(out_coords=nxt.coords, out_valid=nxt.valid, kernel3=(2, 2, 2),
             stride3=(2, 2, 2), pad3=(0, 0, 0), in_dims=DIMS, span=64,
             slots=128, gwin=8, pairs=64)])
    return (nxt, n_s, n_d) + tuple(
        (p.sb, p.se, p.emp, p.gp, p.n_overflow, p.gs) for p in plans)


@pytest.mark.parametrize("S", SLOTS)
def test_make_span_plans(S):
    c3, t, valid = _points(S, 1500, W, 30 + S)
    with torch.inference_mode():
        x = _per_slot(lambda c, tc, v: SL.build_slab(c, tc, v, DIMS, W,
                                                     1024)[0], c3, t, valid)
    got = _assert_equal(_plans, x.keys, x.coords, x.valid, x.occ)
    assert (got[3][5][:, 1] >= 0).any()  # live coverage slots


@pytest.mark.parametrize("S", SLOTS)
def test_voxelize_points_and_bev(S):
    rng = np.random.default_rng(40 + S)
    pts = rng.uniform(-7.0, 7.0, (S, 2000, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3.5, 1.5, (S, 2000))
    pts = torch.from_numpy(pts)
    valid = torch.arange(2000)[None] < torch.tensor(
        [2000 - 300 * s for s in range(S)])[:, None]
    pcr, vs, dims = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0), (0.2, 0.2, 0.4), \
        (64, 64, 10)
    vox, _ = _assert_equal(lambda p, v: voxelize_points(
        p, v, pcr, vs, dims, 1024, 5), pts, valid)
    _assert_equal(to_dense_bev, vox)


@pytest.mark.parametrize("S", SLOTS)
def test_span_op_batching_rule(S):
    """The span conv op over slots on the CPU: its plain version slot by
    slot, with one weight for all slots."""
    c3, t, valid = _points(S, 1500, W, 50 + S)
    with torch.inference_mode():
        x = _per_slot(lambda c, tc, v: SL.build_slab(c, tc, v, DIMS, W,
                                                     1024)[0], c3, t, valid)
    rng = np.random.default_rng(S)
    feats = torch.from_numpy(rng.normal(size=(S, 1024, W * 3)).astype(
        np.float32))
    weight = torch.from_numpy(rng.normal(size=(81, 3, 5)).astype(np.float32))

    def conv(keys, coords, valid, occ, f):
        slab = SL.Slab(keys, coords, occ, f, valid, DIMS, W)
        plan = SC.make_span_plan(keys, coords, valid, (3, 3, 3),
                                 in_dims=DIMS, span=64, slots=256, gwin=8,
                                 pairs=128)
        return plan.conv(slab, weight, slab, (3, 3, 3, 3)).feats

    out = _assert_equal(conv, x.keys, x.coords, x.valid, x.occ, feats)
    assert out.abs().sum() > 0


@pytest.mark.parametrize("S", SLOTS)
def test_nms_op_batching_rule(S):
    """Slots with different candidate counts (one with none from S = 2 on)
    and tied scores; one device-to-host copy for all slots."""
    K, max_out = 300, 40
    rng = np.random.default_rng(60 + S)
    boxes = np.zeros((S, K, 7), np.float32)
    boxes[..., :2] = rng.uniform(0, 15, (S, K, 2))
    boxes[..., 3:6] = rng.uniform(1.0, 4.0, (S, K, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (S, K))
    scores = np.round(rng.random((S, K)), 2).astype(np.float32)
    valid = np.stack([rng.random(K) < p for p in (0.9, 0.0, 0.3)[:S]])
    args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    before = obs.counters()
    with torch.inference_mode(), no_vmap_fallback():
        torch.func.vmap(lambda b, s, v: N.greedy_nms(b, s, v, 0.01, max_out)
                        )(*args)
    assert obs.since(before)["nms.copies"] == 1
    keep = _assert_equal(
        lambda b, s, v: N.greedy_nms(b, s, v, 0.01, max_out), *args)
    counts = keep[1].sum(dim=1).tolist()
    assert counts[0] > 0 and (S == 1 or counts[1] == 0)


def test_pod_step_raises_on_unbatchable_op(monkeypatch):
    """torch.histc has no batching rule: vmap runs it slot by slot through
    its fallback when that is on, and the pod's step, which turns the
    fallback off, raises on it instead; the fallback is on again after."""
    functorch = torch._C._functorch
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(torch.func.vmap(lambda r: torch.histc(r, bins=3))(x),
                       torch.stack([torch.histc(r, bins=3) for r in x]))
    cfg = port_config(tiny_config(window=2))
    params, state = init_params(cfg, np.random.default_rng(0))
    model = make_model(cfg, params, state, "cpu")
    tail = model.forward_tail

    def forward_tail(inter):
        out = tail(inter)
        torch.histc(out["point_logits"], bins=4)
        return out

    monkeypatch.setattr(model, "forward_tail", forward_tail)
    pod = PodInferencePipeline(cfg, model, ["cpu"], slots_per_device=2)
    scans, tfs, _ = hdl64_crop_stream(1)
    with pytest.raises(RuntimeError, match="vmap fallback"):
        pod.push_scans([scans[0], scans[0]], [tfs[0], tfs[0]])
    assert functorch._is_vmap_fallback_enabled()
