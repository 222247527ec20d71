"""The training path's model: the port's train-mode forward (losses, kept
boxes, confusion), its gradients and new BN state, and a train step on a
batch, against the JAX package's on two windows, tiny config, float32, the
same numpy inputs and weights (tests/test_torch_train_steps.py holds the
optimizer, the BN re-estimation and eval steps, the losses, targets and
metrics).

On the CPU both packages train on their windowed engine. The JAX side is
jax.value_and_grad of its per-sample losses (train/step.sample_losses),
compiled once per module. Tolerances (float32): losses within 1e-5
relative; each gradient leaf within 1e-4 * max(1, max|g|); the new BN
state within 1e-5 * max(1, |v|); parameters after an optimizer step
within 1e-6; integer arrays exactly. The heatmap scores are spread
(tools.train_record.SPREAD) and the kept boxes checked equal first."""

import jax
import numpy as np
import optax
import pytest

from insmos_tpu.nn import InsMOSModel as JaxModel
from insmos_tpu.train import optim as joptim
from insmos_tpu.train import step as jstep
from insmos_tpu_torch.data.sample import to_device
from insmos_tpu_torch.train.optim import make_optimizer
from insmos_tpu_torch.train.step import (TrainState, make_train_step,
                                         sample_losses)
from insmos_tpu_torch.tools.train_record import record_params
from insmos_tpu_torch.utils.params import make_model, to_jax_trees

from test_torch_model import port_config
from torch_port_common import hdl64_crop_stream, tiny_config
from torch_train_common import close, stack, train_window, tree_items

LOSSES = ("loss", "cls_loss", "box_loss", "mos_loss", "motion_loss")


@pytest.fixture(scope="module")
def run():
    cfg = tiny_config(window=3, points=1024)
    pcfg = port_config(cfg)
    params, state = record_params(pcfg)
    samples = []
    for seed in (0, 1):
        scans, _, _ = hdl64_crop_stream(3, seed=seed, max_points=1024)
        samples.append(train_window(pcfg, scans, seed))
    jm = JaxModel(cfg)

    def lf(p, s, x):
        total, aux, out = jstep.sample_losses(jm, p, s, x, train=True)
        return total, (aux, {k: out[k] for k in ("boxes", "box_mask")})

    vg = jax.jit(jax.value_and_grad(lf, has_aux=True))
    ref = []
    for s in samples:
        (_, (aux, out)), g = vg(params, state, s)
        ref.append(jax.tree_util.tree_map(np.asarray,
                                          dict(aux=aux, out=out, grads=g)))
    got = []
    for s in samples:
        model = make_model(pcfg, params, state, "cpu")
        total, aux, out = sample_losses(model, to_device(s, "cpu"),
                                        train=True)
        total.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        got.append(dict(aux=aux, out=out, grads=to_jax_trees(grads, pcfg)[0],
                        state=to_jax_trees(aux["new_state"], pcfg)[1]))
    return dict(cfg=cfg, pcfg=pcfg, params=params, state=state,
                samples=samples, ref=ref, got=got, jm=jm)


@pytest.mark.parametrize("i", [0, 1])
def test_train_forward_losses_and_kept_boxes(run, i):
    r, g = run["ref"][i], run["got"][i]
    rm = r["out"]["box_mask"].astype(bool)
    gm = g["out"]["box_mask"].numpy()
    assert rm.sum() == gm.sum() > 0
    # the same kept set (boxes matched within 1e-3: the heading is the
    # atan2 of two near-zero regressions of the random weights, which moves
    # by ~1e-4 with the summation order)
    rb = np.sort(r["out"]["boxes"][rm], axis=0)
    gb = np.sort(g["out"]["boxes"].numpy()[gm], axis=0)
    np.testing.assert_allclose(gb, rb, atol=1e-3)
    for k in LOSSES:
        got, ref = float(g["aux"][k].detach()), float(r["aux"][k])
        assert abs(got - ref) <= 1e-5 * abs(ref), (k, got, ref)
    assert float(r["aux"]["box_loss"]) > 0
    np.testing.assert_array_equal(g["aux"]["confusion"].numpy(),
                                  r["aux"]["confusion"])


@pytest.mark.parametrize("i", [0, 1])
def test_train_gradients_match_jax(run, i):
    r, g = run["ref"][i], run["got"][i]
    got = dict(tree_items(g["grads"]))
    n = 0
    for path, ref in tree_items(r["grads"]):
        assert got[path] is not None, path
        close(got[path], ref, 1e-4, path)
        n += 1
    assert n == len(got) and n > 200


@pytest.mark.parametrize("i", [0, 1])
def test_train_new_bn_state_matches_jax(run, i):
    r, g = run["ref"][i], run["got"][i]
    got = dict(tree_items(g["state"]))
    paths = [p for p, _ in tree_items(r["aux"]["new_state"])]
    assert len(paths) == len(got) > 100
    for path, ref in tree_items(r["aux"]["new_state"]):
        close(got[path], ref, 1e-5, path)
    # every BatchNorm ran in train mode and moved off the initial state
    init = dict(tree_items(run["state"]))
    assert all(not np.array_equal(got[p], init[p]) for p in paths)


def test_train_step_on_a_batch_matches_jax(run):
    """One port train step on the batch of both samples: the mean loss,
    the summed confusion, the averaged BN state and the parameters after
    the Adam update of the mean gradient (optax, the JAX optimizer)."""
    pcfg, cfg = run["pcfg"], run["cfg"]
    model = make_model(pcfg, run["params"], run["state"], "cpu")
    opt, sched = make_optimizer(model, pcfg, steps_per_epoch=10)
    ts = TrainState(model, opt, sched)
    ts, m = make_train_step(model)(ts, to_device(stack(run["samples"]),
                                                 "cpu"))
    assert ts.step == 1
    refs = run["ref"]
    for k in LOSSES:
        ref = np.mean([float(r["aux"][k]) for r in refs])
        assert abs(float(m[k]) - ref) <= 1e-5 * abs(ref), k
    np.testing.assert_array_equal(
        m["confusion"].numpy(), sum(r["aux"]["confusion"] for r in refs))
    grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                   refs[0]["grads"], refs[1]["grads"])
    tx = joptim.make_optimizer(cfg, 10)
    upd, _ = tx.update(grads, tx.init(run["params"]), run["params"])
    new_params = optax.apply_updates(run["params"], upd)
    # Adam's first update is lr * g / (|g| + eps) per element, so where a
    # gradient element lies within the gradient tolerance of zero its sign
    # is summation noise: there the parameter is held to the update's
    # range, 2 * lr (+ 1e-6), and within 1e-6 everywhere else
    got_p, got_s = to_jax_trees(model.state_dict(), pcfg)
    got_p = dict(tree_items(got_p))
    gref = dict(tree_items(grads))
    lr = pcfg.train.lr
    for path, ref in tree_items(new_params):
        noisy = np.abs(gref[path]) <= 1e-4 * max(1.0, np.abs(gref[path]).max())
        err = np.abs(got_p[path] - ref)
        assert err[~noisy].max(initial=0) <= 1e-6, path
        assert err[noisy].max(initial=0) <= 2 * lr + 1e-6, path
    new_state = jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, refs[0]["aux"]["new_state"],
        refs[1]["aux"]["new_state"])
    got_s = dict(tree_items(got_s))
    for path, ref in tree_items(new_state):
        close(got_s[path], ref, 1e-5, path)
