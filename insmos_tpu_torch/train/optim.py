"""The optimizer (port of insmos_tpu/train/optim.py): the reference's
torch.optim.Adam(lr, weight_decay) with its learning rate stepped down by
``lr_decay`` every ``lr_epoch`` epochs. torch's Adam adds the decay to the
gradient before the moment updates, as the reference's optax chain does
(add_decayed_weights -> scale_by_adam -> learning-rate schedule).

``acc_batches > 1`` is optax.MultiSteps: the gradients of k micro-batches
are averaged (a running mean, as optax keeps it) and applied in one update;
the schedule counts updates."""

from __future__ import annotations

import torch


def lr_factor(cfg, steps_per_epoch: int):
    """Update count -> multiple of cfg.train.lr: decay^(epoch // lr_epoch)."""
    def fn(step):
        epoch = step // max(1, steps_per_epoch)
        return cfg.train.lr_decay ** (epoch // cfg.train.lr_epoch)
    return fn


def make_optimizer(model, cfg, steps_per_epoch: int):
    """(Adam over the model's parameters, its per-update LambdaLR)."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.train.lr,
                           betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.train.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lr_factor(cfg, steps_per_epoch))


class GradAccumulator:
    """optax.MultiSteps over ``every_k`` calls: ``add`` folds the current
    .grad of every parameter into a running mean and returns True on the
    k-th call, with that mean left in .grad for the update."""

    def __init__(self, params, every_k: int):
        self.params = [p for p in params]
        self.every_k = every_k
        self.n = 0
        self.acc = None

    def add(self) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.n + 1))
        self.n += 1
        if self.n < self.every_k:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone()
        self.n, self.acc = 0, None
        return True
