"""The training path's steps and parts: the port's optimizer (Adam, the
decay schedule, gradient accumulation), BN re-estimation and eval steps,
losses, targets, gaussians and metrics against the JAX package's, and the
accuracy of the train-mode BEV gradient, tiny config, float32, the same
numpy inputs and weights. Tolerances as tests/test_torch_train.py states
them; the eval step's losses within 1e-4 (the port evaluates on the span
engine's plain route, the JAX package on its windowed engine)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from insmos_tpu.nn import InsMOSModel as JaxModel
from insmos_tpu.ops import gaussian as jgauss
from insmos_tpu.train import loss as jloss
from insmos_tpu.train import metrics as jmetrics
from insmos_tpu.train import optim as joptim
from insmos_tpu.train import step as jstep
from insmos_tpu.train import targets as jtargets
from insmos_tpu_torch.data.sample import to_device
from insmos_tpu_torch.ops import gaussian as tgauss
from insmos_tpu_torch.train import loss as tloss
from insmos_tpu_torch.train import metrics as tmetrics
from insmos_tpu_torch.train.optim import make_optimizer
from insmos_tpu_torch.train.step import (TrainState, make_bn_reestimate,
                                         make_eval_step, optimizer_update)
from insmos_tpu_torch.train.targets import assign_targets
from insmos_tpu_torch.tools.train_record import record_params
from insmos_tpu_torch.utils.params import make_model, to_jax_trees

from test_torch_model import port_config
from torch_port_common import hdl64_crop_stream, tiny_config
from torch_train_common import close, stack, train_window, tree_items


@pytest.fixture(scope="module")
def run():
    cfg = tiny_config(window=3, points=1024)
    pcfg = port_config(cfg)
    params, state = record_params(pcfg)
    samples = []
    for seed in (0, 1):
        scans, _, _ = hdl64_crop_stream(3, seed=seed, max_points=1024)
        samples.append(train_window(pcfg, scans, seed))
    return dict(cfg=cfg, pcfg=pcfg, params=params, state=state,
                samples=samples, jm=JaxModel(cfg))


@pytest.mark.parametrize("acc", [1, 2])
def test_adam_schedule_and_accumulation_match_optax(acc):
    """Three updates of the port's optimizer (Adam with weight decay, the
    per-update decay schedule, optax.MultiSteps's running mean with acc 2)
    against the JAX package's optax chain on the same gradients."""
    cfg = port_config(tiny_config())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr=1e-2, lr_decay=0.5, weight_decay=1e-2,
        acc_batches=acc))
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3 * acc)]
    tx = joptim.make_optimizer(cfg, steps_per_epoch=1)
    jp, js = p0, tx.init(p0)
    for g in grads:
        u, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)

    mod = torch.nn.Module()
    mod.a = torch.nn.Parameter(torch.from_numpy(p0["a"].copy()))
    mod.b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))
    opt, sched = make_optimizer(mod, cfg, steps_per_epoch=1)
    ts = TrainState(mod, opt, sched)
    updates = 0
    for g in grads:
        for k, p in mod.named_parameters():
            p.grad = torch.from_numpy(g[k])
        updates += optimizer_update(ts, acc)
    assert updates == 3
    for k in p0:
        close(getattr(mod, k).detach().numpy(), jp[k], 1e-6, k)
    assert sched.get_last_lr()[0] == pytest.approx(1e-2 * 0.5 ** 3)


def test_bn_reestimate_matches_jax(run):
    batch = stack(run["samples"])
    ref = jax.tree_util.tree_map(np.asarray, jstep.make_bn_reestimate(
        run["jm"])(run["params"], run["state"], batch))
    model = make_model(run["pcfg"], run["params"], run["state"], "cpu")
    got = make_bn_reestimate(model)(to_device(batch, "cpu"))
    got = dict(tree_items(to_jax_trees(got, run["pcfg"])[1]))
    for path, r in tree_items(ref):
        close(got[path], r, 1e-5, path)
    # the momentum is restored after the forced momentum-1 pass
    assert all(m.momentum_scale == 1.0 for m in model.modules()
               if hasattr(m, "momentum_scale"))


def test_eval_step_matches_jax(run):
    """The eval step's metrics and recall keys. The port evaluates on the
    span engine (its plain route here), the JAX package on its windowed
    engine on the CPU."""
    batch = stack(run["samples"])
    ref = jax.tree_util.tree_map(np.asarray, jstep.make_eval_step(
        run["jm"])(run["params"], run["state"], batch))
    model = make_model(run["pcfg"], run["params"], run["state"], "cpu")
    got = make_eval_step(model)(to_device(batch, "cpu"))
    assert set(got) == set(ref) == {"val_loss", "val_motion_loss",
                                    "confusion", "rcnn_0.3", "rcnn_0.5",
                                    "rcnn_0.7", "gt"}
    for k in ("val_loss", "val_motion_loss"):
        close(float(got[k]), float(ref[k]), 1e-4, k)
    for k in ("confusion", "rcnn_0.3", "rcnn_0.5", "rcnn_0.7", "gt"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert int(got["gt"]) == 4


# ------------------------------------------------ losses, targets, metrics
def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(64, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 64).astype(np.int32)
    valid = rng.random(64) < 0.8
    close(float(tloss.mos_loss(_t(logits), _t(labels), _t(valid))),
           float(jloss.mos_loss(logits, labels, valid)), 1e-6, "mos")
    cls = rng.normal(size=(8, 10, 3)).astype(np.float32)
    heat = np.clip(rng.random((3, 8, 10)), 0, 1).astype(np.float32)
    heat[0, 2, 3] = heat[2, 5, 5] = 1.0
    close(float(tloss.gaussian_focal_loss(_t(cls), _t(heat))),
           float(jloss.gaussian_focal_loss(cls, heat)), 1e-6, "focal")
    box_map = rng.normal(size=(6, 8, 8)).astype(np.float32)
    anno = rng.normal(size=(4, 8)).astype(np.float32)
    inds = np.array([3, 10, 17, 0], np.int32)
    mask = np.array([True, True, False, True])
    cw = (1.0,) * 7 + (0.5,)
    close(float(tloss.reg_l1_loss(_t(box_map), _t(anno), _t(inds), _t(mask),
                                   cw)),
           float(jloss.reg_l1_loss(box_map, anno, inds, mask, cw)), 1e-6,
           "l1")


def test_targets_and_gaussians_match_jax():
    cfg = tiny_config()
    pcfg = port_config(cfg)
    gt = np.zeros((cfg.model.head.max_objs, 8), np.float32)
    gt[:4] = [[3.0, 1.0, -0.8, 4.5, 1.9, 1.6, 0.3, 1],
              [-5.0, -4.0, -0.8, 0.8, 0.8, 1.7, 0.0, 2],
              [6.3, 6.3, -0.8, 1.8, 0.7, 1.6, 2.0, 3],
              [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0]]
    ref = jtargets.assign_targets(cfg, jnp.asarray(gt), jnp.int32(4))
    got = assign_targets(pcfg, _t(gt), torch.tensor(4))
    for k in ("inds", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ("heatmap", "anno"):
        close(got[k].numpy(), ref[k], 1e-6, k)
    assert got["mask"][:3].all() and not got["mask"][3:].any()
    h, w = np.float32([3.0, 7.5, 0.4]), np.float32([2.0, 9.0, 0.3])
    close(tgauss.gaussian_radius(_t(h), _t(w), 0.1).numpy(),
           jgauss.gaussian_radius(h, w, 0.1), 1e-6, "radius")


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(200, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 200).astype(np.int32)
    valid = rng.random(200) < 0.9
    cm_ref = np.asarray(jmetrics.confusion_matrix(logits, labels, valid))
    cm = tmetrics.confusion_matrix(_t(logits), _t(labels), _t(valid))
    np.testing.assert_array_equal(cm.numpy(), cm_ref)
    close(tmetrics.iou_from_confusion(cm).numpy(),
           jmetrics.iou_from_confusion(jnp.asarray(cm_ref)), 1e-7, "iou")
    close(float(tmetrics.accuracy_from_confusion(cm)),
           float(jmetrics.accuracy_from_confusion(jnp.asarray(cm_ref))),
           1e-7, "acc")
    gt = np.zeros((5, 8), np.float32)
    gt[0] = [0, 0, 0, 4, 2, 1.5, 0, 1]
    gt[1] = [20, 0, 0, 4, 2, 1.5, 0, 1]
    gt[2] = [-10, 5, 0, 1, 1, 1.7, 0.5, 2]
    pred = np.zeros((4, 7), np.float32)
    pred[0] = [0.1, 0, 0, 4, 2, 1.5, 0]
    pred[1] = [50, 50, 0, 4, 2, 1.5, 0]
    pred[2] = [-10.3, 5.2, 0.1, 1, 1.1, 1.6, 0.6]
    pmask = np.array([True, True, True, False])
    ref = jmetrics.detection_recall(pred, pmask, gt, jnp.int32(3),
                                    (0.3, 0.5, 0.7))
    got = tmetrics.detection_recall(_t(pred), _t(pmask), _t(gt),
                                    torch.tensor(3), (0.3, 0.5, 0.7))
    assert set(got) == set(ref)
    for k in ref:
        assert int(got[k]) == int(ref[k]), k
    from insmos_tpu.ops.iou3d import boxes_iou3d as j_iou3d
    from insmos_tpu_torch.ops.iou3d import boxes_iou3d as t_iou3d

    close(t_iou3d(_t(pred), _t(gt[:, :7])).numpy(), j_iou3d(pred, gt[:, :7]),
           1e-6, "iou3d")


def test_bev_gradient_against_float64():
    """The BEV backbone, head and focal loss in train mode: the input
    gradient of the port's float32 route within 1e-5 of its float64 run
    (relative to the largest), the JAX package's float32 gradient beyond
    1e-3 of it. The reference's train-mode BatchNorm backward subtracts the
    focal loss's common-mode gradient with XLA's sequential float32 sums; a
    reference caveat, which loosens the record's gradient bounds
    (tools/train_record.TOLERANCES)."""
    from insmos_tpu.nn.bev_backbone import bev_backbone_forward as jbev
    from insmos_tpu.nn.center_head import center_head_forward as jhead
    from insmos_tpu_torch.nn.bev_backbone import bev_backbone_forward as tbev
    from insmos_tpu_torch.nn.center_head import center_head_forward as thead

    cfg = tiny_config(window=3, points=1024)
    pcfg = port_config(cfg)
    params, state = record_params(pcfg)
    rng = np.random.default_rng(0)
    bev = np.zeros((32, 32, 256), np.float32)
    occupied = rng.random((32, 32)) < 0.3
    bev[occupied] = rng.standard_normal((occupied.sum(), 256)).astype(
        np.float32)
    heat = np.zeros((3, 64, 64), np.float32)
    heat[0, 10, 10] = heat[1, 30, 40] = 1.0
    heat[0, 11, 10] = 0.6

    def jl(b):
        f, _ = jbev(params["bev"], state["bev"], cfg, b, train=True)
        return jloss.gaussian_focal_loss(jhead(params["head"], f)[0], heat)

    jg = np.asarray(jax.grad(jl)(jnp.asarray(bev)), np.float64)
    grads = []
    for dt in (torch.float32, torch.float64):
        model = make_model(pcfg, params, state, "cpu").to(dt)
        b = torch.from_numpy(bev).to(dt).requires_grad_(True)
        cls, _ = thead(model.head, tbev(model.bev, pcfg, b, None, True))
        tloss.gaussian_focal_loss(cls, torch.from_numpy(heat).to(dt)
                                  ).backward()
        grads.append(b.grad.double().numpy())
    g32, g64 = grads
    scale = np.abs(g64).max()
    assert np.abs(g32 - g64).max() <= 1e-5 * scale
    assert np.abs(jg - g64).max() > 1e-3 * scale


def test_window_engine_inference_matches_jax(run):
    """sparse_engine "window" at inference: the windowed engine on the
    t-pruned schedule (slot-offset convs, no decoder pruning), against the
    JAX package's forward on its windowed engine; logits within 1e-4."""
    cfg = dataclasses.replace(run["cfg"], runtime=dataclasses.replace(
        run["cfg"].runtime, sparse_engine="window"))
    pcfg = port_config(cfg)
    s = run["samples"][0]
    ref = jax.jit(lambda p, st, x: JaxModel(cfg).forward(
        p, st, x, train=False))(run["params"], run["state"], s)
    model = make_model(pcfg, run["params"], run["state"], "cpu")
    got = model(to_device(s, "cpu"))
    assert "span_overflow" not in got["overflow"]
    for k in ("motion_logits", "point_logits", "cls_map"):
        close(got[k].numpy(), np.asarray(ref[k]), 1e-4, k)
