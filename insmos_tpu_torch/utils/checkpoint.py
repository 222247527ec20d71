"""Checkpoints with a config snapshot (the port's counterpart of
``insmos_tpu/utils/checkpoint.py``, which stores orbax trees).

A checkpoint is a directory holding ``config.json``, the full Config as
JSON exactly as the JAX package writes it, and ``model.pt``, a torch file
with the model's state dict (CPU tensors), the step and, from training, the
optimizer's and the learning-rate schedule's state. ``predict_mos --ckpt``
restores the configuration it was saved with; ``train --checkpoint``
resumes with the optimizer state. :func:`save_checkpoint_from_trees`
writes one from the numpy (params, state) trees that
``utils.params.load_jax_params`` takes: the JAX package's trees as numpy,
``init_params``' random ones, or a converted reference checkpoint
(``utils.convert``). Checkpoints without optimizer state (inference
checkpoints) load as before.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from ..config import Config

_CONFIG_FILE = "config.json"
_STATE_FILE = "model.pt"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _save(path: str, cfg: Config, state_dict: dict, step: int,
          opt_state: dict | None = None) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    blob = {"model": _cpu(state_dict), "step": int(step)}
    if opt_state is not None:
        blob["opt_state"] = _cpu(opt_state)
    torch.save(blob, os.path.join(path, _STATE_FILE))
    with open(os.path.join(path, _CONFIG_FILE), "w") as fh:
        json.dump(cfg.to_dict(), fh, indent=1)


def optimizer_state(optimizer, scheduler) -> dict:
    """The training state a resume needs beside the weights."""
    return {"optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict()}


def save_checkpoint(path: str, cfg: Config, model, step: int = 0,
                    opt_state: dict | None = None) -> None:
    """Write ``model``'s state, ``cfg`` and, when given, the optimizer
    state (:func:`optimizer_state`) to the directory ``path``."""
    _save(path, cfg, model.state_dict(), step, opt_state)


def save_checkpoint_from_trees(path: str, cfg: Config, params, state,
                               step: int = 0) -> None:
    """Write a checkpoint from numpy (params, state) trees shaped like the
    JAX package's ``InsMOSModel.init``."""
    from .params import load_jax_params

    _save(path, cfg, load_jax_params(params, state, "cpu"), step)


def load_checkpoint(path: str, device="cuda", cfg: Config | None = None,
                    with_opt: bool = False):
    """Returns (cfg, model, step): the model in eval mode on ``device`` (the
    card unless the caller names the CPU), built at ``cfg`` (default: the
    checkpoint's own config) and holding the checkpoint's weights. With
    ``with_opt``, (cfg, model, step, opt_state): the saved optimizer state,
    or None when the checkpoint has none."""
    from ..nn.model import InsMOSModel

    path = os.path.abspath(path)
    if cfg is None:
        with open(os.path.join(path, _CONFIG_FILE)) as fh:
            cfg = Config.from_dict(json.load(fh))
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    model = InsMOSModel(cfg).to(device)
    model.load_state_dict(blob["model"], strict=True)
    if with_opt:
        return cfg, model.eval(), int(blob["step"]), blob.get("opt_state")
    return cfg, model.eval(), int(blob["step"])


def best_checkpoint_manager(root: str, max_to_keep: int = 2):
    """Keep the top ``max_to_keep`` checkpoints by validation MOS IoU plus a
    ``last``: the reference's ModelCheckpoint(save_top_k=2, monitor=
    val_mos_iou, mode=max, save_last=True)."""

    class Manager:
        def __init__(self):
            self.scores: list[tuple[float, str]] = []
            os.makedirs(root, exist_ok=True)

        def save(self, cfg, model, opt_state, step, score: float):
            path = os.path.join(root, f"epoch{step}_iou{score:.4f}")
            save_checkpoint(path, cfg, model, step, opt_state)
            save_checkpoint(os.path.join(root, "last"), cfg, model, step,
                            opt_state)
            self.scores.append((score, path))
            self.scores.sort(key=lambda t: -t[0])
            for _, stale in self.scores[max_to_keep:]:
                shutil.rmtree(stale, ignore_errors=True)
            self.scores = self.scores[:max_to_keep]

    return Manager()
