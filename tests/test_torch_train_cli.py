"""The port's training CLI end to end on the CPU (tiny config, a synthetic
KITTI sequence, the real train and eval steps): the epoch loop, the
reference's scalar names, the top-2 + last checkpoints with optimizer
state, a resume that continues exactly where a run stopped, and the port's
predict_mos on the best checkpoint; the checkpoint format of inference
checkpoints stays readable."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from insmos_tpu_torch.cli import predict_mos
from insmos_tpu_torch.cli import train as tcli
from insmos_tpu_torch.data.synthetic import write_synthetic_sequence
from insmos_tpu_torch.tools.train_record import record_params
from insmos_tpu_torch.utils.io import artifact_dirs
from insmos_tpu_torch.utils.checkpoint import (load_checkpoint,
                                               save_checkpoint_from_trees)

from test_torch_model import port_config
from torch_port_common import tiny_config

SCALARS = ("train_loss", "cls_loss", "box_loss", "mos_loss", "motion_loss",
           "train_mos_iou_step", "val_mos_iou_step", "recall_rcnn_3",
           "recall_rcnn_5", "recall_rcnn_7", "recall_roi_3", "recall_roi_5",
           "recall_roi_7")


def _train(cfg_path, root, out, epochs, *extra):
    return tcli.main(["--config", cfg_path, "--data", root, "--epochs",
                      str(epochs), "--out", out, "--device", "cpu",
                      "--log_every", "1", *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    root = str(tmp / "kitti")
    write_synthetic_sequence(root, seq=0, n_scans=6, seed=3, n_ground=400,
                             n_per_obj=40)
    cfg = port_config(tiny_config(window=3, points=1024))
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, split_train=(0,), split_val=(0,),
                                 num_workers=2),
        train=dataclasses.replace(cfg.train, batch_size=2))
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as fh:
        json.dump(cfg.to_dict(), fh)
    full = _train(cfg_path, root, str(tmp / "full"), 2, "--bn_reest", "1")
    half = str(tmp / "half")
    _train(cfg_path, root, half, 1, "--bn_reest", "1")
    resumed = _train(cfg_path, root, str(tmp / "resumed"), 2, "--bn_reest",
                     "1", "--checkpoint", os.path.join(half, "ckpt", "last"))
    return dict(tmp=tmp, root=root, cfg=cfg, full=full, resumed=resumed,
                half=half)


def test_train_cli_loop_scalars_and_checkpoints(runs):
    out = str(runs["tmp"] / "full")
    assert runs["full"].step == 4  # 2 epochs of 4 windows at batch 2
    scalars = [json.loads(line)
               for line in open(os.path.join(out, "scalars.jsonl"))]
    keys = set().union(*(set(s) for s in scalars))
    for name in SCALARS:
        assert name in keys, name
    assert all(np.isfinite(s["train_loss"]) for s in scalars
               if "train_loss" in s)
    assert [s["step"] for s in scalars if "val_mos_iou_step" in s] == [2, 4]
    names = sorted(os.listdir(os.path.join(out, "ckpt")))
    assert "last" in names and len(names) == 3  # top-2 + last
    cfg, model, step, opt = load_checkpoint(
        os.path.join(out, "ckpt", "last"), "cpu", with_opt=True)
    assert step == 4 and cfg == runs["cfg"]
    assert opt["optimizer"]["state"] and opt["scheduler"]["last_epoch"] == 4
    assert tcli.best_checkpoint(out) in [os.path.join(out, "ckpt", n)
                                         for n in names if n != "last"]


def test_train_cli_resume_continues_exactly(runs):
    """One epoch, then a resume from its last checkpoint for the second:
    the optimizer state and step come back and the result equals the
    two-epoch run's."""
    _, _, step1, opt1 = load_checkpoint(
        os.path.join(runs["half"], "ckpt", "last"), "cpu", with_opt=True)
    assert step1 == 2 and opt1["scheduler"]["last_epoch"] == 2
    assert runs["resumed"].step == 4
    a, b = runs["full"], runs["resumed"]
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7, msg=n)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k in sa["state"]:
        for f in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa["state"][k][f], sb["state"][k][f],
                                       rtol=1e-6, atol=1e-9)


def test_predict_mos_loads_the_best_checkpoint(runs):
    ckpt = tcli.best_checkpoint(str(runs["tmp"] / "full"))
    stats = predict_mos.main(["--ckpt", ckpt, "--data_path", runs["root"],
                              "--sequences", "0", "--out",
                              str(runs["tmp"] / "preb"), "--device", "cpu"])
    assert stats["scans"] == 6
    dirs = artifact_dirs(str(runs["tmp"] / "preb"),
                         runs["cfg"].experiment_id, 0)
    assert len(os.listdir(dirs["mos"])) == 6


def test_inference_checkpoint_format_still_loads(tmp_path):
    """A checkpoint as inference writes it (weights and step, no optimizer
    state) loads in both forms."""
    cfg = port_config(tiny_config())
    params, state = record_params(cfg)
    path = str(tmp_path / "ckpt")
    save_checkpoint_from_trees(path, cfg, params, state, step=7)
    blob = torch.load(os.path.join(path, "model.pt"), weights_only=True)
    assert set(blob) == {"model", "step"}
    _, model, step = load_checkpoint(path, "cpu")
    _, model2, step2, opt = load_checkpoint(path, "cpu", with_opt=True)
    assert step == step2 == 7 and opt is None
    for (n, x), (_, y) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(x, y), n
