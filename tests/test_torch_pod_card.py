"""The multi-stream pod's batched device ops on the card: the span-conv
kernel launched once over S slots (grid z) and the NMS over a slot axis
(needs the card).

The batched span kernel must equal S single-slot launches bit for bit (each
slot's arithmetic is that of a single launch) and its plain version within
5e-4 x max(1, |plain|), as tests/test_torch_span_kernel.py holds a single
launch; f32 and bf16 operands, S = 3, each slot its own site set and plan
(live coverage slots, uncovered rows and dead blocks), one folded weight for
all. Through the op under ``torch.func.vmap`` (the pod's route) it is one
launch. The NMS under vmap keeps what ``greedy_nms`` keeps slot by slot,
with one device-to-host copy.

Run on the card with:
    python -m pytest --noconftest -m gpu tests/test_torch_pod_card.py
(--noconftest: the repository's conftest imports jax, which the GPU
machine does not have).
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree

from insmos_tpu_torch import obs
from insmos_tpu_torch.ops import nms as N
from insmos_tpu_torch.pipeline import no_vmap_fallback
from insmos_tpu_torch.sparse import span_conv as SC

from test_torch_span_kernel import _slab

pytestmark = pytest.mark.gpu

S = 3
# (TC, TO, kx): vec 2 and 8 feature copies, one and two column tiles
SHAPES = [(10, 96, 5), (60, 8, 3), (80, 160, 3), (128, 320, 3)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slots(TC, TO, kx, dev, dtype):
    """S slots' (keys, feats, coords, valid, plan) on one geometry and one
    folded weight (G, kx*TC, TO)."""
    dims, cap, bs = (96, 40, 12), 6144, 128
    slots = []
    for s in range(S):
        rng = np.random.default_rng(10 + s)
        x = _slab(rng, dev, 4000 + 500 * s, dims, 1, 1, cap)
        valid = x.valid.clone()
        valid[(s + 1) * bs:(s + 2) * bs] = False  # a dead output block
        plan = SC.make_span_plan(
            x.keys, x.coords, valid, (kx, 3, 3), in_dims=dims, span=128,
            slots=512, gwin=6, pairs=160, bs=bs)
        feats = torch.from_numpy(
            rng.normal(size=(cap, TC)).astype(np.float32)).to(dev).to(dtype)
        slots.append((x.keys, feats, x.coords, valid, plan))
    rng = np.random.default_rng(0)
    wg = torch.from_numpy((rng.normal(size=(9, kx * TC, TO)) * 0.1).astype(
        np.float32)).to(dev).to(dtype)
    return slots, wg


def _stacked_plan(plans):
    p = plans[0]
    return SC._plan_of(torch.stack([q.sb for q in plans]),
                       torch.stack([q.emp for q in plans]), p.gp,
                       torch.stack([q.gs for q in plans]), SC._plan_geom(p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"TC{a}_TO{b}_kx{c}" for a, b, c in SHAPES])
def test_batched_kernel_equals_single_launches(shape, dtype, cuda):
    slots, wg = _slots(*shape, cuda, dtype)
    assert all(int((p.gs[1] >= 0).sum()) > 0 for *_, p in slots)
    keys, feats, coords, valid = (torch.stack([s[i] for s in slots])
                                  for i in range(4))
    plan = _stacked_plan([s[4] for s in slots])
    before = obs.counters()
    got = SC.span_conv_core_cuda(keys, feats, wg, coords, valid, plan)
    torch.cuda.synchronize()
    assert obs.since(before)["span_conv.launches"] == 1
    assert got.shape == (S, coords.shape[1], wg.shape[2])
    for s, (k, f, c, v, p) in enumerate(slots):
        one = SC.span_conv_core_cuda(k, f, wg, c, v, p)
        assert torch.equal(got[s], one), s
        ref = SC.span_conv_core_plain(k, f, wg, c, v, p)
        scale = max(1.0, float(ref.abs().max()))
        assert float((got[s] - ref).abs().max()) <= 5e-4 * scale, s
        assert not got[s][~v].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_vmapped_op_is_one_launch(dtype, cuda):
    """The op under vmap (the pod's route): one launch over the slots,
    equal to the op slot by slot."""
    slots, wg = _slots(80, 160, 3, cuda, dtype)

    def conv(k, f, c, v, sb, emp, gs, gp):
        return SC.span_conv_op(k, f, wg, c, v, sb, emp, gp, gs,
                               SC._plan_geom(slots[0][4]))

    args = [torch.stack([s[i] for s in slots]) for i in range(4)] + [
        torch.stack([getattr(s[4], a) for s in slots])
        for a in ("sb", "emp", "gs")]
    gp = slots[0][4].gp
    before = obs.counters()
    with torch.inference_mode(), no_vmap_fallback():
        got = torch.func.vmap(conv, in_dims=(0,) * 7 + (None,))(*args, gp)
    torch.cuda.synchronize()
    assert obs.since(before)["span_conv.launches"] == 1
    for s in range(S):
        one = conv(*(a[s] for a in args), gp)
        assert torch.equal(got[s], one), s


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(0, 20, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(1.0, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_batched_nms_matches_per_slot(cuda):
    """Slots with different candidate counts, one with none valid, ties in
    the scores: the vmapped op keeps what greedy_nms keeps on each slot,
    on the card and on the CPU, with one device-to-host copy."""
    K, max_out = 600, 100
    rng = np.random.default_rng(3)
    boxes = np.stack([_boxes(rng, K) for _ in range(S)])
    scores = np.round(rng.random((S, K)), 2).astype(np.float32)
    valid = np.stack([rng.random(K) < p for p in (0.9, 0.0, 0.3)])
    args = [torch.from_numpy(a).to(cuda) for a in (boxes, scores, valid)]
    before = obs.counters()
    with torch.inference_mode(), no_vmap_fallback():
        got = torch.func.vmap(N.greedy_nms, in_dims=(0, 0, 0, None, None))(
            *args, 0.01, max_out)
    assert obs.since(before)["nms.copies"] == 1
    for s in range(S):
        for dev in (cuda, torch.device("cpu")):
            one = N.greedy_nms(*(a[s].to(dev) for a in args), 0.01, max_out)
            _pytree.tree_map(lambda x, y: torch.testing.assert_close(
                x.cpu(), y.cpu(), rtol=0, atol=0), (got[0][s], got[1][s]), one)
    assert not got[1][1].any() and got[1][0].sum() > got[1][2].sum() > 0
