"""The port learns: the counterpart of tests/test_train.py::
test_overfit_tiny_scene, with its configuration, scene and thresholds. 60
unstubbed train steps on one tiny synthetic scene must cut the total loss
at least 10x and lift both the moving and the static class's IoU above
0.5. Weights from init_params(cfg, default_rng(1)) (the JAX test draws
jax.random.PRNGKey(1), which the port cannot reproduce)."""

import dataclasses

import numpy as np
import torch

from insmos_tpu_torch.config import (Config, DataConfig, MotionNetConfig)
from insmos_tpu_torch.data.sample import to_device
from insmos_tpu_torch.train.metrics import iou_from_confusion
from insmos_tpu_torch.train.optim import make_optimizer
from insmos_tpu_torch.train.step import TrainState, make_train_step
from insmos_tpu_torch.utils.params import init_params, make_model

import torch_port_common  # noqa: F401  (thread cap)


def test_overfit_tiny_scene():
    base = Config()
    cfg = dataclasses.replace(
        base,
        data=DataConfig(point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)),
        model=dataclasses.replace(
            base.model,
            n_past_steps=2,
            max_voxels=2048,
            unet_capacities=(2048, 1024, 512, 256, 256),
            motionnet=MotionNetConfig(
                crop_range=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.8),
                site_capacities=(4096, 2048, 1024, 512),
            ),
        ),
        train=dataclasses.replace(base.train, lr=2e-3, lr_decay=1.0),
        runtime=dataclasses.replace(base.runtime, max_points_per_scan=512),
    )
    W, P = 2, 512
    rng = np.random.default_rng(0)
    # points with x > 1 are MOVING (2), the rest STATIC (1); one car box
    # around the moving cluster
    pts = np.zeros((W, P, 4), np.float32)
    pts[..., 0] = rng.uniform(-6, 6, (W, P))
    pts[..., 1] = rng.uniform(-6, 6, (W, P))
    pts[..., 2] = rng.uniform(-2, 0.5, (W, P))
    pts[..., 3] = rng.uniform(0, 1, (W, P))
    labels = np.where(pts[..., 0] > 1.0, 2, 1).astype(np.int32)
    boxes = np.zeros((cfg.model.head.max_objs, 8), np.float32)
    boxes[0] = [3.5, 0.0, -0.8, 4.5, 1.9, 1.6, 0.2, 1]
    sample = {
        "points": pts,
        "num_points": np.full((W,), P, np.int32),
        "scan_mask": np.ones((W,), bool),
        "labels": labels,
        "gt_boxes": boxes,
        "num_boxes": np.int32(1),
    }
    batch = to_device({k: np.asarray(v)[None] for k, v in sample.items()},
                      "cpu")

    params, state = init_params(cfg, np.random.default_rng(1))
    model = make_model(cfg, params, state, "cpu")
    opt, sched = make_optimizer(model, cfg, steps_per_epoch=1_000_000)
    ts = TrainState(model, opt, sched)
    step = make_train_step(model)
    losses, cm = [], None
    for _ in range(60):
        ts, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))
        cm = metrics["confusion"]
    first, last = losses[0], min(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < first / 10, f"loss {first:.3f} -> {last:.3f}: did not learn"
    iou = iou_from_confusion(cm).numpy()
    assert iou[2] > 0.5, f"moving IoU {iou[2]:.3f} <= chance"
    assert iou[1] > 0.5, f"static IoU {iou[1]:.3f} <= chance"
    assert int(cm.sum()) == P  # every point of the current scan
