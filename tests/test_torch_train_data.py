"""The labelled data layer of the training path: the port's copies of the
JAX package's processor, augment and sample modules, its
KittiWindowDataset, ScanCache and batch iterators, and make_hdl64_window,
held equal to the JAX package's (numpy arrays bit for bit)."""

import dataclasses

import numpy as np
import pytest

from insmos_tpu import native as jax_native
from insmos_tpu.data import augment as jaug
from insmos_tpu.data import hdl64 as jhdl
from insmos_tpu.data import kitti as jkitti
from insmos_tpu.data import loader as jloader
from insmos_tpu.data import processor as jproc
from insmos_tpu.data import sample as jsample
from insmos_tpu_torch.data import augment as taug
from insmos_tpu_torch.data import hdl64 as thdl
from insmos_tpu_torch.data import kitti as tkitti
from insmos_tpu_torch.data import loader as tloader
from insmos_tpu_torch.data import processor as tproc
from insmos_tpu_torch.data import sample as tsample
from insmos_tpu_torch.data.synthetic import write_synthetic_sequence

from test_torch_model import port_config
from torch_port_common import tiny_config

ARRAYS = ("points", "num_points", "scan_mask", "labels", "gt_boxes",
          "num_boxes")


def _eq_sample(a, b):
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.meta == b.meta


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_train")
    for seq in (0, 1):
        write_synthetic_sequence(str(root), seq=seq, n_scans=6, seed=3 + seq,
                                 n_ground=400, n_per_obj=40)
    return str(root)


def _cfgs(augmentation=False, shuffle=False, window=3):
    cfg = tiny_config(window=window, points=512)
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, split_train=(0, 1),
                                 split_val=(1,), split_test=(0,),
                                 shuffle=shuffle),
        train=dataclasses.replace(cfg.train, augmentation=augmentation))
    return cfg, port_config(cfg)


def test_processor_and_sample_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-70, 70, (500, 4)).astype(np.float32)
    rngc = (-60.0, -50.0, -4.0, 60.0, 50.0, 2.0)
    np.testing.assert_array_equal(tproc.mask_points_by_range(pts, rngc),
                                  jproc.mask_points_by_range(pts, rngc))
    np.testing.assert_array_equal(tproc.rotate_points_z(pts, 0.7),
                                  jproc.rotate_points_z(pts, 0.7))
    boxes = np.concatenate([rng.uniform(-65, 65, (20, 3)),
                            rng.uniform(0.5, 5, (20, 3)),
                            rng.uniform(-3, 3, (20, 1))], -1)
    np.testing.assert_array_equal(tproc.boxes_to_corners_3d(boxes),
                                  jproc.boxes_to_corners_3d(boxes))
    np.testing.assert_array_equal(tproc.mask_boxes_outside_range(boxes, rngc),
                                  jproc.mask_boxes_outside_range(boxes, rngc))
    scans = [pts[:300], pts[300:]]
    labels = [np.arange(300) % 3, np.arange(200) % 3]
    gt = np.concatenate([boxes[:3], np.ones((3, 1))], -1)
    a = tsample.make_window_sample(scans, 256, 4, labels, gt, 10, meta="m")
    b = jsample.make_window_sample(scans, 256, 4, labels, gt, 10, meta="m")
    _eq_sample(a, b)
    sa, sb = tsample.stack_samples([a, a]), jsample.stack_samples([b, b])
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_window_matches_jax_under_equal_generators(seed):
    rng = np.random.default_rng(10 + seed)
    pts = rng.uniform(-30, 30, (400, 4)).astype(np.float32)
    boxes = rng.uniform(-10, 10, (5, 7))
    a = taug.augment_window(pts.copy(), boxes.copy(),
                            np.random.default_rng(seed))
    b = jaug.augment_window(pts.copy(), boxes.copy(),
                            rng=np.random.default_rng(seed))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("split", ["train", "val"])
def test_labelled_samples_match_jax(root, split):
    """Shuffle and augmentation off (their draws come from different
    generators in the two packages), every window of the split."""
    cfg, pcfg = _cfgs()
    a = tkitti.KittiWindowDataset(pcfg, split, root_dir=root)
    b = jkitti.KittiWindowDataset(cfg, split, root_dir=root)
    assert len(a) == len(b) > 0 and a.index == b.index
    for i in range(len(a)):
        _eq_sample(a[i], b[i])
    assert any((a[i].labels == 2).any() for i in range(len(a)))
    if split == "val":  # training drops the boxes outside the range
        assert all(a[i].num_boxes > 0 for i in range(len(a)))


def test_warmup_window_and_unlabelled_samples_match_jax(root, monkeypatch):
    """A 2-scan warm-up window in 3 slots, and the label-free path against
    the JAX package's native loader's numpy route."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_failed", True)
    cfg, pcfg = _cfgs()
    for kw in (dict(window=2), dict(with_labels=False)):
        split = "test" if "with_labels" in kw else "val"
        a = tkitti.KittiWindowDataset(pcfg, split, root_dir=root, **kw)
        b = jkitti.KittiWindowDataset(cfg, split, root_dir=root, **kw)
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            _eq_sample(a[i], b[i])


def test_augmented_samples_are_seeded(root):
    """With augmentation and the in-scan shuffle on, a sample is a function
    of (seed, epoch, index): the same in two datasets, drawn anew in
    another epoch or under another seed."""
    _, pcfg = _cfgs(augmentation=True, shuffle=True)
    a = tkitti.KittiWindowDataset(pcfg, "train", root_dir=root, seed=4)
    b = tkitti.KittiWindowDataset(pcfg, "train", root_dir=root, seed=4)
    c = tkitti.KittiWindowDataset(pcfg, "train", root_dir=root, seed=5)
    _eq_sample(a[1], b[1])
    s0 = a[1]
    assert not np.array_equal(s0.points, c[1].points)
    a.set_epoch(1)
    assert not np.array_equal(s0.points, a[1].points)
    b.set_epoch(1)
    _eq_sample(a[1], b[1])


def test_iter_batches_and_samples_match_jax(root):
    cfg, pcfg = _cfgs()
    a = tkitti.KittiWindowDataset(pcfg, "train", root_dir=root)
    b = jkitti.KittiWindowDataset(cfg, "train", root_dir=root)
    for shuffle, workers in ((True, 2), (False, 0), (True, 0)):
        ga = list(tloader.iter_batches(a, 2, shuffle, seed=5,
                                       num_workers=workers))
        gb = list(jloader.iter_batches(b, 2, shuffle, seed=5,
                                       num_workers=workers))
        assert len(ga) == len(gb) == len(a) // 2
        for x, y in zip(ga, gb):
            for k in ARRAYS:
                np.testing.assert_array_equal(x[k], y[k])
    for x, y in zip(tloader.iter_samples(a, 2), jloader.iter_samples(b, 2)):
        _eq_sample(x, y)
    stats = a.cache.stats()
    assert stats["hits"] > 0 and stats["entries"] > 0


def test_scan_cache_returns_copies():
    cache = tloader.ScanCache(max_bytes=100)
    calls = []

    def load():
        calls.append(1)
        return np.arange(10, dtype=np.float32)

    x = cache.get(("a", "pc"), load)
    x[0] = 99
    y = cache.get(("a", "pc"), load)
    assert y[0] == 0 and len(calls) == 1
    cache.get(("b", "pc"), load)
    cache.get(("c", "pc"), load)  # 3 x 40 bytes > 100: "a" is evicted
    assert cache.stats()["entries"] == 2
    cache.get(("a", "pc"), load)
    assert len(calls) == 4


def test_make_hdl64_window_matches_jax():
    cfg, pcfg = _cfgs()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, max_points_per_scan=4096))
    pcfg = port_config(cfg)
    a = thdl.make_hdl64_window(pcfg, seed=3, n_scans=2)
    b = jhdl.make_hdl64_window(cfg, seed=3, n_scans=2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["labels"] == 2).any()
