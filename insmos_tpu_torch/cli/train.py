"""Training CLI (the port of ``insmos_tpu/cli/train.py``): train from
scratch, from weights, or resume with the optimizer state; validate every
epoch with MOS IoU and detection recall; keep the top-2 and the last
checkpoints; log scalars under the reference's names to JSONL and, when it
imports, TensorBoard.

  python -m insmos_tpu_torch.cli.train --data <root> [--config cfg.yaml]
      [--weights ckpt] [--checkpoint ckpt] [--epochs N] [--batch_size B]
      [--out runs/exp] [--seed S] [--log_every K] [--bn_reest K]
      [--device cuda|cpu]

Runs on one device, the card unless ``--device`` names another; a batch of
B samples is one optimizer update. Under torchrun it is data-parallel, one
process per device:

  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m insmos_tpu_torch.cli.train ...

Each rank runs on ``cuda:LOCAL_RANK`` (or the device ``--device`` names,
gloo between CPU processes), builds the same global batch from the same
seed and trains on its contiguous shard of it (``parallel.shard_batch``),
with the gradients all-reduced once a step; B must be a multiple of the
ranks that take a shard (``parallel.data_world_for_batch``). Only rank 0
logs, prints and writes checkpoints; a resume restores the same state on
every rank. Without ``--weights``/``--checkpoint``
the weights are ``utils.params.init_params(cfg, default_rng(seed))`` (the
JAX CLI's ``jax.random.PRNGKey(seed)`` draws cannot be reproduced).
Training takes the windowed engine, validation the span engine (its CUDA
kernel on the card), as the config's ``sparse_engine`` "auto" selects.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from .. import setup_device
from ..config import Config
from ..data.kitti import KittiWindowDataset
from ..data.loader import iter_batches
from ..data.sample import to_device
from ..parallel import (close_world, data_world_for_batch, init_world,
                        rank_device, replicate, shard_batch)
from ..train.metrics import iou_from_confusion
from ..train.optim import make_optimizer
from ..train.step import (TrainState, load_bn_state, make_bn_reestimate,
                          make_eval_step, make_train_step)
from ..utils.checkpoint import (best_checkpoint_manager, load_checkpoint,
                                optimizer_state)
from ..utils.params import init_params, make_model


class ScalarLogger:
    """Scalars to ``scalars.jsonl`` under ``logdir``, and to TensorBoard
    when ``torch.utils.tensorboard`` imports."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            pass
        self._fh = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def log(self, step: int, **scalars):
        vals = {k: float(v) for k, v in scalars.items()}
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(k, v, step)
        self._fh.write(json.dumps({"step": step, **vals}) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def best_checkpoint(out: str) -> str | None:
    """The best checkpoint a run under ``out`` kept (highest validation MOS
    IoU, the earliest among equals), or None."""
    root = os.path.join(out, "ckpt")
    best = None
    for name in os.listdir(root) if os.path.isdir(root) else []:
        if name.startswith("epoch") and "_iou" in name:
            step, iou = name[5:].split("_iou")
            key = (-float(iou), int(step))
            if best is None or key < best[0]:
                best = (key, os.path.join(root, name))
    return best[1] if best else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="InsMOS training (PyTorch)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data", type=str, default=os.environ.get("DATA", ""))
    p.add_argument("--weights", type=str, default=None,
                   help="init from a checkpoint's weights")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume, optimizer state included")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--out", type=str, default="runs/insmos")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument(
        "--bn_reest", type=int, default=0,
        help="re-estimate BN running stats from this many train batches "
        "at the end of every epoch (momentum-1 forwards, averaged), for "
        "short schedules where the reference momenta cannot converge the "
        "running statistics (see train/step.make_bn_reestimate)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the card; under "
                   "torchrun cuda:LOCAL_RANK)")
    return p.parse_args(argv)


def run(args) -> TrainState:
    """Trains as the arguments say; under torchrun's environment as one
    rank of a data-parallel world, whose process group is closed on the
    way out."""
    device = setup_device(rank_device(args.device))
    world = init_world(device)
    try:
        return _train(args, device, world)
    finally:
        close_world(world)


def _train(args, device, world) -> TrainState:
    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=args.batch_size))
    train_ds = KittiWindowDataset(cfg, "train", root_dir=args.data,
                                  seed=args.seed)
    val_ds = KittiWindowDataset(cfg, "val", root_dir=args.data)
    bsz = cfg.train.batch_size
    steps_per_epoch = max(1, len(train_ds) // bsz)
    world = data_world_for_batch(world, bsz)

    opt_state, step0 = None, 0
    if args.checkpoint:
        _, model, step0, opt_state = load_checkpoint(
            args.checkpoint, device, cfg, with_opt=True)
    elif args.weights:
        _, model, _ = load_checkpoint(args.weights, device, cfg)
    else:
        params, state = init_params(cfg, np.random.default_rng(args.seed))
        model = make_model(cfg, params, state, device)
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state["optimizer"])
        scheduler.load_state_dict(opt_state["scheduler"])
    start_epoch = step0 // steps_per_epoch
    replicate(world, model)
    ts = TrainState(model, optimizer, scheduler, step0)
    train_step = make_train_step(model, world)
    eval_step = make_eval_step(model, world)
    bn_step = make_bn_reestimate(model, world) if args.bn_reest else None
    main = world.is_main
    logger = ScalarLogger(args.out) if main else None
    ckpt_mgr = (best_checkpoint_manager(os.path.join(args.out, "ckpt"))
                if main else None)
    workers = cfg.data.num_workers

    def log(**scalars):
        if main:
            logger.log(ts.step, **scalars)

    def shard(batch):
        return to_device(shard_batch(world, batch), device)

    max_epoch = args.epochs or cfg.train.max_epoch
    for epoch in range(start_epoch, max_epoch):
        train_ds.set_epoch(epoch)
        cm = np.zeros((3, 3), np.int64)
        t0 = time.perf_counter()
        for i, batch in enumerate(iter_batches(
                train_ds, bsz, cfg.data.shuffle, seed=args.seed + epoch,
                num_workers=workers)):
            ts, metrics = train_step(ts, shard(batch))
            cm += metrics["confusion"].cpu().numpy()
            if i % args.log_every == 0:
                log(train_loss=metrics["loss"], cls_loss=metrics["cls_loss"],
                    box_loss=metrics["box_loss"], mos_loss=metrics["mos_loss"],
                    motion_loss=metrics["motion_loss"])
        train_iou = float(iou_from_confusion(cm)[2])
        log(train_mos_iou_step=train_iou)

        if bn_step is not None:
            total, k = None, 0
            for batch in iter_batches(train_ds, bsz, cfg.data.shuffle,
                                      seed=args.seed * 7919 + epoch,
                                      num_workers=workers):
                sb = bn_step(shard(batch))
                total = sb if total is None else {
                    n: total[n] + v for n, v in sb.items()}
                k += 1
                if k >= args.bn_reest:
                    break
            load_bn_state(model, {n: v / k for n, v in total.items()})

        # ---- validation ----
        vcm = np.zeros((3, 3), np.int64)
        rec = {}
        for batch in iter_batches(val_ds, bsz, shuffle=False,
                                  num_workers=workers):
            m = eval_step(shard(batch))
            vcm += m["confusion"].cpu().numpy()
            for key, v in m.items():
                if key.startswith(("rcnn", "gt")):
                    rec[key] = rec.get(key, 0) + int(v)
        val_iou = float(iou_from_confusion(vcm)[2])
        gt_num = max(rec.get("gt", 0), 1)
        # the reference's names: recall_rcnn_<int(t*10)>; recall_roi_*
        # stays 0 (InsMOS has no second-stage rois)
        recall = {}
        for key, v in rec.items():
            if key.startswith("rcnn_"):
                name = int(round(float(key[5:]) * 10))
                recall[f"recall_rcnn_{name}"] = v / gt_num
                recall[f"recall_roi_{name}"] = 0.0
        log(val_mos_iou_step=val_iou, **recall)
        if main:
            print(f"epoch {epoch}: train_iou={train_iou:.4f} "
                  f"val_iou={val_iou:.4f} ({time.perf_counter() - t0:.0f}s)")
            ckpt_mgr.save(cfg, model, optimizer_state(optimizer, scheduler),
                          ts.step, val_iou)
    if main:
        logger.close()
    return ts


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
