"""Voxelizer, box geometry, NMS, box decode and box fusion features: the
port against the JAX package.

Integer outputs are compared exactly. Float tolerances: the voxel means
sum the same float32 values in another order (1e-6); the clipped-polygon
IoU runs the same float32 arithmetic (1e-5); box decode applies the same
elementwise ops (1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insmos_tpu.ops import box_utils as jbu
from insmos_tpu.ops import iou3d as jiou
from insmos_tpu.ops import nms as jnms
from insmos_tpu.ops import points_in_boxes as jpib
from insmos_tpu.sparse import bev as jbev
from insmos_tpu.sparse import voxelize as jvox
from insmos_tpu.sparse.tensor import SparseTensor as JSparse
from insmos_tpu_torch import obs
from insmos_tpu_torch.ops import box_utils as tbu
from insmos_tpu_torch.ops import iou3d as tiou
from insmos_tpu_torch.ops import nms as tnms
from insmos_tpu_torch.ops import points_in_boxes as tpib
from insmos_tpu_torch.sparse import bev as tbev
from insmos_tpu_torch.sparse import voxelize as tvox
from insmos_tpu_torch.sparse.tensor import SparseTensor as TSparse

PC_RANGE = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)
VOXEL = (0.1, 0.1, 0.1)
DIMS = (128, 128, 40)


@pytest.mark.parametrize("cap", [4096, 300])
def test_voxelize_and_devoxelize(cap):
    """First-occurrence cap (the second capacity drops voxels), p2v = -1
    on drops and out-of-range points."""
    rng = np.random.default_rng(cap)
    n = 3000
    pts = np.concatenate([rng.uniform(-7, 7, (n, 2)), rng.uniform(-3.5, 1.5,
                                                                  (n, 1)),
                          rng.normal(size=(n, 4))], -1).astype(np.float32)
    pts[: n // 3, :3] = np.round(pts[: n // 3, :3], 1)  # repeated voxels
    valid = rng.random(n) > 0.05
    jv, jp = jvox.voxelize_points(jnp.asarray(pts), jnp.asarray(valid),
                                  PC_RANGE, VOXEL, DIMS, cap, 5)
    tv, tp = tvox.voxelize_points(torch.from_numpy(pts),
                                  torch.from_numpy(valid), PC_RANGE, VOXEL,
                                  DIMS, cap, 5)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    for f in ("keys", "coords", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jv, f)),
                                      getattr(tv, f).numpy())
    np.testing.assert_array_equal(tv.feats.numpy(), np.asarray(jv.feats))
    vf = rng.normal(size=(cap, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jvox.devoxelize(jnp.asarray(vf), jp)),
        tvox.devoxelize(torch.from_numpy(vf), tp).numpy())


def _boxes(rng, m, spread=10.0, size=(1.0, 4.0)):
    b = np.concatenate([
        rng.uniform(-spread, spread, (m, 2)), rng.uniform(-1, 1, (m, 1)),
        rng.uniform(*size, (m, 3)), rng.uniform(-np.pi, np.pi, (m, 1)),
    ], -1)
    return b.astype(np.float32)


def test_boxes_iou_bev():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40, 4.0), _boxes(rng, 30, 4.0)
    b[:5] = a[:5]  # identical pairs
    b[5, 3:5] = 0.0  # a degenerate box
    ref = np.asarray(jiou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (ref > 0.05).sum() > 10
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tiou.iou_bev_pairs(torch.from_numpy(a[:30]),
                           torch.from_numpy(b)).numpy(),
        np.diag(ref[:30]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("max_out", [500, 7])
def test_greedy_nms_separated_boxes(max_out):
    """Identical kept set and order: clusters of overlapping boxes, well
    separated from each other, with distinct scores."""
    rng = np.random.default_rng(1)
    centres = np.stack(np.meshgrid(np.arange(6) * 12.0, np.arange(5) * 12.0),
                       -1).reshape(-1, 2)
    boxes = []
    for c in centres:
        k = rng.integers(1, 5)
        bx = _boxes(rng, k, 0.6, (1.5, 3.0))
        bx[:, :2] += c
        boxes.append(bx)
    boxes = np.concatenate(boxes)
    K = len(boxes)
    scores = rng.permutation(K).astype(np.float32) / K
    valid = rng.random(K) > 0.1
    ji, jm = jnms.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid), 0.01, max_out)
    ti, tm = tnms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), 0.01, max_out)
    jm, tm = np.asarray(jm), tm.numpy()
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(np.asarray(ji)[jm], ti.numpy()[tm])
    assert 0 < tm.sum() < valid.sum()


def _deployment_candidates(rng, K, dense):
    """K candidates as decode_and_nms hands them to the NMS: a few dozen
    above the gate, in overlapping clusters with distinct scores, a few
    exact score ties between overlapping boxes (broken by index), the rest
    below the gate; with ``dense``, one cluster of 460 live boxes whose
    bounding circles all touch (over PAIRS_PER_BOX pairs a box of K)."""
    boxes = _boxes(rng, K, 60.0, (0.5, 2.0))
    scores = rng.uniform(0.0, 0.1, K).astype(np.float32)
    valid = np.zeros(K, bool)
    live = rng.choice(K, 520 if dense else 48, replace=False)
    centres = rng.uniform(-50, 50, (12, 2))
    boxes[live[:48], :2] = (centres[np.arange(48) % 12]
                            + rng.uniform(-1.0, 1.0, (48, 2)))
    if dense:
        boxes[live[48:], :2] = rng.uniform(-0.8, 0.8, (len(live) - 48, 2))
        boxes[live[48:], 3:5] = rng.uniform(1.5, 2.0, (len(live) - 48, 2))
    s = 0.1 + 0.9 * (rng.permutation(len(live)) + 1) / (len(live) + 1)
    scores[live] = s.astype(np.float32)
    valid[live] = True
    # exact ties between boxes of one cluster: the lower index goes first
    for a, b in ((0, 12), (1, 13), (2, 26)):
        scores[live[b]] = scores[live[a]]
    return boxes, scores, valid


@pytest.mark.parametrize("dense", [False, True], ids=["deployment", "dense"])
def test_greedy_nms_deployment_regime(dense):
    """The NMS as the calibrated weights run it: K = 4096 candidates, a few
    dozen above the gate in overlapping clusters, score ties broken by
    index. greedy_nms and greedy_nms_slots (S = 3, each slot its own
    candidates) give the JAX greedy_nms's keep_idx and keep_mask exactly;
    the dense cluster overflows the pair list (one more copy a call)."""
    rng = np.random.default_rng(7 + dense)
    K = 4096
    slots = [_deployment_candidates(rng, K, dense) for _ in range(3)]
    ref = [tuple(np.asarray(a) for a in jnms.greedy_nms(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), 0.01, 500))
        for b, s, v in slots]
    assert all(3 <= m.sum() < v.sum() for (_, m), (_, _, v) in zip(ref,
                                                                     slots))
    before = obs.counters()
    b, s, v = (torch.from_numpy(x) for x in slots[0])
    ti, tm = tnms.greedy_nms(b, s, v, 0.01, 500)
    np.testing.assert_array_equal(ti.numpy(), ref[0][0])
    np.testing.assert_array_equal(tm.numpy(), ref[0][1])
    got = obs.since(before)
    assert (got["nms.copies"], got["nms.pair_overflows"]) == (
        (2, 1) if dense else (1, 0))
    before = obs.counters()
    bs, ss, vs = (torch.from_numpy(np.stack(x)) for x in zip(*slots))
    ti, tm = tnms.greedy_nms_slots(bs, ss, vs, 0.01, 500)
    for i, (ri, rm) in enumerate(ref):
        np.testing.assert_array_equal(ti[i].numpy(), ri)
        np.testing.assert_array_equal(tm[i].numpy(), rm)
    got = obs.since(before)
    assert (got["nms.copies"], got["nms.pair_overflows"]) == (
        (2, 1) if dense else (1, 0))


def test_decode_center_boxes():
    rng = np.random.default_rng(2)
    bp = rng.normal(size=(12, 10, 8)).astype(np.float32)
    ref = jbu.decode_center_boxes(jnp.asarray(bp), VOXEL, PC_RANGE, 4)
    got = tbu.decode_center_boxes(torch.from_numpy(bp), VOXEL, PC_RANGE, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_box_class_features():
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 64, (2000, 3)).astype(np.float32)
    boxes = _boxes(rng, 25, 30.0, (4.0, 20.0))
    boxes[:, :2] += 32.0
    boxes = np.concatenate([boxes, rng.integers(-1, 4, (25, 1))], -1).astype(
        np.float32)
    bvalid = rng.random(25) > 0.2
    ref = jpib.box_class_features(jnp.asarray(coords), jnp.asarray(boxes), 3,
                                  jnp.asarray(bvalid))
    got = tpib.box_class_features(torch.from_numpy(coords),
                                  torch.from_numpy(boxes), 3,
                                  torch.from_numpy(bvalid))
    assert np.asarray(ref).sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tpib.points_in_rotated_boxes_np(coords, boxes),
        tpib.points_in_rotated_boxes(torch.from_numpy(coords),
                                     torch.from_numpy(boxes)).numpy())


def _instance_ids(pts, boxes, offset, bvalid=None):
    """The JAX function's and the port's ids on the same float32 inputs."""
    ref = jpib.points_in_instance_boxes(
        jnp.asarray(pts), jnp.asarray(boxes), 3, offset,
        None if bvalid is None else jnp.asarray(bvalid))
    got = tpib.points_in_instance_boxes(
        torch.from_numpy(pts), torch.from_numpy(boxes), 3, offset,
        None if bvalid is None else torch.from_numpy(bvalid))
    assert got.dtype == torch.int32
    return np.asarray(ref), got.numpy()


def test_points_in_instance_boxes_ids_and_ground_offset():
    """The JAX package's case (tests/test_ops.py): box ids per class, the
    ground offset lifting box centres, the max id where boxes overlap."""
    pts = np.float32([[0.0, 0.0, 0.0], [0.0, 0.0, -0.95], [5.0, 5.0, 0.0]])
    boxes = np.zeros((2, 8), np.float32)
    boxes[0] = [0, 0, 0, 2, 2, 2, 0, 1]
    boxes[1] = [5, 5, 0, 2, 2, 2, 0, 1]
    ref, got = _instance_ids(pts, boxes, 0.1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 0], [1, 0, 2])
    np.testing.assert_array_equal(got[:, 1:], 0)
    boxes[1] = [0, 0, 0, 2, 2, 2, 0, 1]
    ref, got = _instance_ids(pts, boxes, 0.0)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_points_in_instance_boxes_random(seed):
    """Random rotated boxes of classes -1..3 (some overlapping, some
    masked) over random points: the ids equal the JAX function's."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, 3000)
    boxes = _boxes(rng, 40, 15.0, (2.0, 10.0))
    boxes = np.concatenate([boxes, rng.integers(-1, 4, (40, 1))], -1).astype(
        np.float32)
    bvalid = rng.random(40) > 0.2
    ref, got = _instance_ids(pts, boxes, 0.3, bvalid)
    np.testing.assert_array_equal(got, ref)
    hit = got > 0
    assert hit.any(axis=0).sum() == 3
    # overlapping boxes of one class occur, and resolve to the larger id
    inside = tpib.points_in_rotated_boxes_np(
        pts, boxes + np.float32([0, 0, 0.3, 0, 0, 0, 0, 0]))
    cls0 = (boxes[:, 7] == 1) & bvalid
    assert (inside[:, cls0].sum(axis=1) > 1).any()


def test_to_dense_bev():
    rng = np.random.default_rng(4)
    dims = (10, 8, 3)
    keys = np.sort(rng.choice(np.prod(dims), 60, replace=False)).astype(
        np.int32)
    coords = np.stack([keys % 10, keys // 10 % 8, keys // 80], -1).astype(
        np.int32)
    cap = 64
    keys_p = np.concatenate([keys, np.full(cap - 60, 2**31 - 1, np.int32)])
    coords_p = np.concatenate([coords, np.zeros((cap - 60, 3), np.int32)])
    valid = np.arange(cap) < 60
    f = rng.normal(size=(cap, 5)).astype(np.float32)
    ref = jbev.to_dense_bev(JSparse(jnp.asarray(coords_p), jnp.asarray(keys_p),
                                    jnp.asarray(f), jnp.asarray(valid), dims))
    got = tbev.to_dense_bev(TSparse(torch.from_numpy(coords_p),
                                    torch.from_numpy(keys_p),
                                    torch.from_numpy(f),
                                    torch.from_numpy(valid), dims))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
