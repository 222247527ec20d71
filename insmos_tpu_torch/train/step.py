"""Train, BN re-estimation and eval steps (port of
insmos_tpu/train/step.py).

The reference vmaps the per-sample forward over a batch, so each sample
normalises with its own BatchNorm statistics; here the samples are looped
over. The loss is the mean over samples (each sample's backward adds its
share to the gradients), the new BN state the mean of the samples' new
running statistics, and the confusion matrix their sum."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..nn.layers import set_bn_momentum_scale
from .loss import gaussian_focal_loss, mos_loss, reg_l1_loss
from .metrics import confusion_matrix, detection_recall
from .optim import GradAccumulator
from .targets import assign_targets

LOSS_KEYS = ("loss", "cls_loss", "box_loss", "mos_loss", "motion_loss")


@dataclass
class TrainState:
    """The model, its optimizer and schedule, and the count of train-step
    calls (every call, as the reference's ``ts.step``; with acc_batches > 1
    the schedule counts updates)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    step: int = 0
    accumulator: GradAccumulator | None = field(default=None, repr=False)


def batch_size(batch: dict) -> int:
    return batch["points"].shape[0]


def sample_of(batch: dict, i: int) -> dict:
    return {k: v[i] for k, v in batch.items()}


def sample_losses(model, sample: dict, *, train: bool):
    """One sample's forward and its four losses. Returns (total, aux, out);
    aux holds the losses, the confusion matrix and, in train mode, the new
    BN state."""
    cfg = model.cfg
    out = model(sample, train=train)
    W = sample["points"].shape[0]
    labels = sample["labels"][W - 1]
    valid = out["point_valid"]
    l_motion = mos_loss(out["motion_logits"], labels, valid)
    l_mos = mos_loss(out["point_logits"], labels, valid)
    tgt = assign_targets(cfg, sample["gt_boxes"], sample["num_boxes"])
    hc = cfg.model.head
    l_cls = gaussian_focal_loss(out["cls_map"], tgt["heatmap"]) * \
        hc.cls_weight
    l_box = reg_l1_loss(out["box_map"], tgt["anno"], tgt["inds"],
                        tgt["mask"], hc.code_weights) * hc.loc_weight
    total = l_cls + l_box + l_mos
    if cfg.model.use_motion_loss:
        total = total + l_motion
    aux = {"loss": total, "cls_loss": l_cls, "box_loss": l_box,
           "mos_loss": l_mos, "motion_loss": l_motion,
           "confusion": confusion_matrix(out["point_logits"], labels, valid)}
    if "new_state" in out:
        aux["new_state"] = out["new_state"]
    return total, aux, out


def _mean_state(states):
    return {k: torch.stack([s[k] for s in states]).mean(dim=0)
            for k in states[0]}


def load_bn_state(model, state: dict) -> None:
    """Write BN state entries (``<module>.mean`` / ``.var``) into the
    model's buffers."""
    with torch.no_grad():
        buffers = dict(model.named_buffers())
        for k, v in state.items():
            buffers[k].copy_(v)


def optimizer_update(ts: TrainState, every_k: int = 1) -> bool:
    """Apply the gradients in the parameters' .grad: one optimizer update
    and one schedule step, or with ``every_k`` > 1 one accumulation, the
    update on every k-th call (optax.MultiSteps). Returns whether the
    parameters changed."""
    if every_k > 1:
        if ts.accumulator is None:
            ts.accumulator = GradAccumulator(ts.model.parameters(), every_k)
        if not ts.accumulator.add():
            return False
    ts.optimizer.step()
    ts.scheduler.step()
    return True


def make_train_step(model):
    """Returns step(ts, batch, out_hook=None) -> (ts, metrics): one
    optimizer update (or one accumulation, with acc_batches > 1) on a batch
    of stacked tensors. Metrics are the losses' means over the samples (0-d
    tensors) and the confusion matrix's sum; ``out_hook`` sees each
    sample's model outputs (the overflow counters, say)."""
    k = model.cfg.train.acc_batches

    def step(ts: TrainState, batch: dict, out_hook=None):
        model.train()
        ts.optimizer.zero_grad(set_to_none=True)
        B = batch_size(batch)
        losses, cms, states = [], [], []
        for i in range(B):
            total, aux, out = sample_losses(model, sample_of(batch, i),
                                            train=True)
            if out_hook is not None:
                out_hook(out)
            (total / B).backward()
            losses.append(torch.stack([aux[n].detach() for n in LOSS_KEYS]))
            cms.append(aux["confusion"])
            states.append(aux["new_state"])
        optimizer_update(ts, k)
        load_bn_state(model, _mean_state(states))
        ts.step += 1
        mean = torch.stack(losses).mean(dim=0)
        metrics = dict(zip(LOSS_KEYS, mean))
        metrics["confusion"] = torch.stack(cms).sum(dim=0)
        return ts, metrics

    return step


def make_bn_reestimate(model):
    """Returns step(batch) -> the batch's BN statistics (state entries,
    averaged over its samples): train-mode forwards with every BatchNorm's
    momentum forced to 1, so the new state IS the batch statistics. The
    caller averages over K batches (``train --bn_reest K``): on short
    schedules the reference's small momenta leave the running statistics
    far from the ones the train-mode forward normalises with."""
    scale = model.cfg.train.bn_momentum_scale

    @torch.no_grad()
    def step(batch: dict):
        set_bn_momentum_scale(model, 1e9)
        try:
            states = [model(sample_of(batch, i), train=True)["new_state"]
                      for i in range(batch_size(batch))]
        finally:
            set_bn_momentum_scale(model, scale)
        return _mean_state(states)

    return step


def make_eval_step(model):
    """Returns step(batch) -> metrics: val_loss (the MOS loss) and
    val_motion_loss as means, the confusion matrix, and the recall counts
    rcnn_<t> and gt as sums over the batch."""
    thresh = model.cfg.model.post.recall_thresh_list

    @torch.no_grad()
    def step(batch: dict):
        model.eval()
        rows = []
        for i in range(batch_size(batch)):
            s = sample_of(batch, i)
            _, aux, out = sample_losses(model, s, train=False)
            rec = detection_recall(out["boxes"][:, :7], out["box_mask"],
                                   s["gt_boxes"], s["num_boxes"], thresh)
            rows.append({"val_loss": aux["mos_loss"],
                         "val_motion_loss": aux["motion_loss"],
                         "confusion": aux["confusion"], **rec})
        return {k: (torch.stack([r[k] for r in rows]).sum(dim=0)
                    if k == "confusion" or k.startswith(("rcnn", "gt"))
                    else torch.stack([r[k] for r in rows]).mean())
                for k in rows[0]}

    return step
