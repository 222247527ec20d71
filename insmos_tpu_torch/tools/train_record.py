"""Train-step parity against a committed record of the JAX package.

The JAX package cannot run beside the port on the card, so one float32
train step of its (``tests/torch_train_record.py``, on the CPU) is
condensed into a record, ``tests/torch_goldens/train_record.npz``, beside
the same step of the port's CPU route. This module holds everything of
that comparison that needs no jax, for the record script, the tests and
``chip_smoke.py`` alike:

- :func:`record_config`, :func:`record_sample`, :func:`record_params`: the
  step's configuration, window and weights;
- :func:`summarize`: the five losses, the confusion matrix, the kept
  boxes, every gradient leaf's norm and a fixed seeded sample of its
  entries, the same entries of every parameter after one Adam update,
  and the whole new BN state;
- :func:`port_summary`: the port's train step, summarized;
- :func:`compare`: a summary against the record's, within
  :data:`TOLERANCES`.

The record is a cut of the full default Config: the default widths and
window (W=10), 12,288 points a scan of the HDL-64E raycast window, and the
MotionNet site capacities cut to match (the windowed engine runs every
capacity row, whatever the points occupy).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import Config

RECORD = os.path.join("tests", "torch_goldens", "train_record.npz")
POINTS = 12_288
# L1..L8 site capacities of the cut: the record window's union of
# 12,288-point scans holds 70,105 / 38,403 / 18,401 / 7,623 sites
SITE_CAPACITIES = (131_072, 65_536, 32_768, 16_384)
N_SAMPLE = 32  # sampled entries per leaf
STEPS_PER_EPOCH = 4768  # the reference schedule's ~19k samples at batch 4
# the class heatmap conv's scale: spread scores, so that greedy NMS keeps
# the same boxes whatever the summation order, with the logits kept off the
# focal loss's clip at 1 - 1e-4 (logit 9.2), where float32 cannot tell a
# clipped cell from one that is not
SPREAD = 5.0
# the four boxes of the JAX package's tools/measure_train_step.py
BOXES = np.array(
    [[10, 5, -0.8, 4.5, 1.9, 1.6, 0.3, 1],
     [-8, 2, -0.9, 4.2, 1.8, 1.5, 1.1, 1],
     [3, -12, -0.7, 0.8, 0.8, 1.7, 0.0, 2],
     [15, 8, -0.8, 1.8, 0.7, 1.6, 2.0, 3]], np.float32)
LOSSES = ("loss", "cls_loss", "box_loss", "mos_loss", "motion_loss")

# Per reference summary, relative to max(1, max |reference|) of each array:
# losses, gradient norms, sampled gradient entries, the new BN state.
# Parameters after the Adam update: within ``param_abs`` where the
# reference's gradient entry exceeds grad_rel of its leaf's norm, else
# within 2 * lr + param_abs (Adam's first update is lr * g / (|g| + eps):
# a gradient entry at the comparison's noise level has a noise sign). Kept
# boxes: the same number, each matched within ``box_abs``. Integers
# (confusion, box count) exactly.
# "jax": the JAX package's float32 gradients carry an error of their own.
# Its train-mode BatchNorm backward over the dense BEV subtracts the focal
# loss's common-mode gradient with XLA's sequential float32 sums: on an
# isolated BEV backbone + head + focal loss, its input gradient is 1.06e-2
# (relative to its largest) off a float64 run, the port's 1.4e-6
# (tests/test_torch_train.py::test_bev_gradient_against_float64). On this
# record the port's CPU route reads 1.8e-6 on the losses, 1.2e-3 on the
# gradient norms and 2.6e-3 on the sampled gradient entries against it.
# "port_cpu": the port's own CPU route, the same sums in other orders and,
# on the card, atomic scatter-adds. The card's first reading (NVIDIA H100
# 80GB HBM3, 700 W): losses 1.1e-7, gradient norms 1.6e-4, sampled
# gradient entries 1.3e-3, BN state 8.9e-8, kept boxes within 5.0e-5;
# two runs on the card differ by up to 2.7e-6 in a gradient.
TOLERANCES = {
    "jax": dict(loss_rel=1e-4, grad_norm_rel=3e-3, grad_rel=1e-2,
                state_rel=1e-4, param_abs=1e-6, box_abs=1e-3),
    "port_cpu": dict(loss_rel=1e-5, grad_norm_rel=5e-4, grad_rel=5e-3,
                     state_rel=1e-5, param_abs=1e-6, box_abs=1e-3),
}


def record_config(cfg: Config | None = None) -> Config:
    """The record's cut of ``cfg`` (default: the full default Config), in
    float32."""
    cfg = cfg or Config()
    mc = cfg.model
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(mc, motionnet=dataclasses.replace(
            mc.motionnet, site_capacities=SITE_CAPACITIES)),
        runtime=dataclasses.replace(cfg.runtime, max_points_per_scan=POINTS,
                                    compute_dtype="float32"))


def record_sample(cfg: Config, seed: int = 0) -> dict:
    """make_hdl64_window at the config's points a scan with its moving
    labels, and the four boxes."""
    from ..data.hdl64 import make_hdl64_window

    s = make_hdl64_window(cfg, seed=seed)
    s["gt_boxes"][:len(BOXES)] = BOXES
    s["num_boxes"] = np.int32(len(BOXES))
    return s


def record_params(cfg: Config, seed: int = 0):
    """init_params(cfg, default_rng(seed)) with the heatmap conv scaled by
    SPREAD."""
    from ..utils.params import init_params

    params, state = init_params(cfg, np.random.default_rng(seed))
    params["head"]["cls"]["w"] = params["head"]["cls"]["w"] * np.float32(
        SPREAD)
    return params, state


def fingerprint(sample: dict, params) -> dict:
    """Float64 sums of the window and the weights, so that a record can be
    checked against the inputs that the functions above make today."""
    return {"points": float(np.asarray(sample["points"], np.float64).sum()),
            "labels": int(np.asarray(sample["labels"]).sum()),
            "params": float(sum(v.astype(np.float64).sum()
                                for _, v in _leaves(params)))}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def sample_indices(size: int, path: str) -> np.ndarray:
    """The fixed entries sampled of a leaf of ``size`` entries."""
    seed = sum(path.encode()) * 7919 + size
    n = min(N_SAMPLE, size)
    return np.sort(np.random.default_rng(seed).choice(size, n,
                                                      replace=False))


def summarize(losses: dict, confusion, boxes, box_mask, grads, params_after,
              new_state) -> dict[str, np.ndarray]:
    """A train step as flat numpy arrays. ``grads`` and ``params_after``
    are params-shaped trees, ``new_state`` a state-shaped tree (the JAX
    layouts), ``boxes``/``box_mask`` the kept boxes."""
    out = {f"loss/{k}": np.float32(losses[k]) for k in LOSSES}
    out["confusion"] = np.asarray(confusion, np.int64)
    m = np.asarray(box_mask, bool)
    out["boxes"] = np.asarray(boxes, np.float32)[m]
    params = dict(_leaves(params_after))
    for path, g in _leaves(grads):
        idx = sample_indices(g.size, path)
        out[f"grad_norm/{path}"] = np.float32(np.linalg.norm(g))
        out[f"grad/{path}"] = g.reshape(-1)[idx]
        out[f"param/{path}"] = params[path].reshape(-1)[idx]
    for path, v in _leaves(new_state):
        out[f"state/{path}"] = v
    return out


def port_summary(cfg: Config, params, state, sample: dict, device,
                 with_grads: bool = False):
    """One port train step (batch 1) from numpy trees: its summary, and
    with ``with_grads`` also every gradient ({parameter name: tensor})."""
    from ..data.sample import to_device
    from ..train.optim import make_optimizer
    from ..train.step import TrainState, sample_losses, optimizer_update
    from ..train.step import load_bn_state
    from ..utils.params import make_model, to_jax_trees

    model = make_model(cfg, params, state, device)
    model.train()
    opt, sched = make_optimizer(model, cfg, STEPS_PER_EPOCH)
    total, aux, out = sample_losses(model, to_device(sample, device),
                                    train=True)
    total.backward()
    raw = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    grads = to_jax_trees(raw, cfg)[0]
    optimizer_update(TrainState(model, opt, sched))
    load_bn_state(model, aux["new_state"])
    after, new_state = to_jax_trees(model.state_dict(), cfg)
    summary = summarize({k: float(aux[k].detach()) for k in LOSSES},
                        aux["confusion"].cpu().numpy(),
                        out["boxes"].detach().cpu().numpy(),
                        out["box_mask"].cpu().numpy(), grads, after,
                        new_state)
    return (summary, raw) if with_grads else summary


def save_record(path: str, cfg: Config, summaries: dict[str, dict],
                **meta) -> None:
    """``summaries``: {"jax": ..., "port_cpu": ...}."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {f"{name}:{k}": v for name, s in summaries.items()
            for k, v in s.items()}
    np.savez_compressed(path, config=np.array(json.dumps(cfg.to_dict())),
                        meta=np.array(json.dumps(meta)), **flat)


def load_record(path: str):
    """(cfg, meta, {name: summary}) of a record file."""
    out: dict[str, dict] = {}
    with np.load(path) as z:
        cfg = Config.from_dict(json.loads(str(z["config"])))
        meta = json.loads(str(z["meta"]))
        for k in z.files:
            if k not in ("config", "meta"):
                name, key = k.split(":", 1)
                out.setdefault(name, {})[key] = z[k]
    return cfg, meta, out


def match_boxes(ref, got, tol: float) -> tuple[bool, float]:
    """Whether every record box has its own port box within ``tol`` (each
    parameter), and the largest matched distance."""
    if len(ref) != len(got):
        return False, float("inf")
    if not len(ref):
        return True, 0.0
    d = np.abs(ref[:, None, :] - got[None, :, :]).max(-1)
    match = d.argmin(1)
    worst = float(d.min(1).max())
    return bool(worst <= tol and len(set(match)) == len(match)), worst


def compare(ref: dict, got: dict, lr: float,
            tol: dict) -> tuple[list[str], dict]:
    """(failures, readings): the summary ``got`` against the reference
    summary ``ref``, within ``tol`` (an entry of TOLERANCES)."""
    fails, read = [], {}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    if set(got) != set(ref):
        fails.append(f"keys differ: {sorted(set(got) ^ set(ref))[:5]}")
        return fails, read
    read["loss_rel"] = max(rel(got[k], ref[k]) for k in ref
                           if k.startswith("loss/"))
    read["grad_norm_rel"] = max(rel(got[k], ref[k]) for k in ref
                                if k.startswith("grad_norm/"))
    read["grad_rel"] = max(rel(got[k], ref[k]) for k in ref
                           if k.startswith("grad/"))
    read["state_rel"] = max(rel(got[k], ref[k]) for k in ref
                            if k.startswith("state/"))
    worst_p = worst_noisy = 0.0
    for k in ref:
        if not k.startswith("param/"):
            continue
        g = ref["grad/" + k[6:]]
        noisy = np.abs(g) <= tol["grad_rel"] * max(
            1.0, float(ref["grad_norm/" + k[6:]]))
        err = np.abs(got[k].astype(np.float64) - ref[k])
        worst_p = max(worst_p, float(err[~noisy].max(initial=0)))
        worst_noisy = max(worst_noisy, float(err[noisy].max(initial=0)))
    read["param_abs"], read["param_abs_noisy"] = worst_p, worst_noisy
    ok_boxes, read["box_abs"] = match_boxes(ref["boxes"], got["boxes"],
                                            tol["box_abs"])
    read["kept"] = [len(ref["boxes"]), len(got["boxes"])]
    read["confusion_equal"] = bool(np.array_equal(ref["confusion"],
                                                  got["confusion"]))
    for k in ("loss_rel", "grad_norm_rel", "grad_rel", "state_rel",
              "param_abs"):
        if read[k] > tol[k]:
            fails.append(f"{k} {read[k]:.3g} > {tol[k]}")
    if worst_noisy > 2 * lr + tol["param_abs"]:
        fails.append(f"param_abs_noisy {worst_noisy:.3g} > 2 lr")
    if not ok_boxes:
        fails.append(f"kept boxes {read['kept']} matched within "
                     f"{read['box_abs']:.3g} > {tol['box_abs']}")
    if not read["confusion_equal"]:
        fails.append("confusion differs")
    return fails, read
