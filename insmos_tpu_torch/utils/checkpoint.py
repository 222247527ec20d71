"""Checkpoints with a config snapshot (the port's counterpart of
``insmos_tpu/utils/checkpoint.py``, which stores orbax trees).

A checkpoint is a directory holding ``config.json``, the full Config as
JSON exactly as the JAX package writes it, and ``model.pt``, a torch file
with the model's state dict (CPU tensors) and the step. ``predict_mos
--ckpt`` restores the configuration it was saved with.
:func:`save_checkpoint_from_trees` writes one from the numpy (params, state)
trees that ``utils.params.load_jax_params`` takes: the JAX package's trees as
numpy, ``init_params``' random ones, or a converted reference checkpoint
(``utils.convert``). Optimizer state is not stored.
"""

from __future__ import annotations

import json
import os

import torch

from ..config import Config

_CONFIG_FILE = "config.json"
_STATE_FILE = "model.pt"


def _save(path: str, cfg: Config, state_dict: dict, step: int) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    cpu = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    torch.save({"model": cpu, "step": int(step)},
               os.path.join(path, _STATE_FILE))
    with open(os.path.join(path, _CONFIG_FILE), "w") as fh:
        json.dump(cfg.to_dict(), fh, indent=1)


def save_checkpoint(path: str, cfg: Config, model, step: int = 0) -> None:
    """Write ``model``'s state and ``cfg`` to the directory ``path``."""
    _save(path, cfg, model.state_dict(), step)


def save_checkpoint_from_trees(path: str, cfg: Config, params, state,
                               step: int = 0) -> None:
    """Write a checkpoint from numpy (params, state) trees shaped like the
    JAX package's ``InsMOSModel.init``."""
    from .params import load_jax_params

    _save(path, cfg, load_jax_params(params, state, "cpu"), step)


def load_checkpoint(path: str, device="cuda", cfg: Config | None = None):
    """Returns (cfg, model, step): the model in eval mode on ``device`` (the
    card unless the caller names the CPU), built at ``cfg`` (default: the
    checkpoint's own config) and holding the checkpoint's weights."""
    from ..nn.model import InsMOSModel

    path = os.path.abspath(path)
    if cfg is None:
        with open(os.path.join(path, _CONFIG_FILE)) as fh:
            cfg = Config.from_dict(json.load(fh))
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    model = InsMOSModel(cfg).to(device)
    model.load_state_dict(blob["model"], strict=True)
    return cfg, model.eval(), int(blob["step"])
