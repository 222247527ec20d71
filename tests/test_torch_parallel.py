"""Data parallelism in the port (insmos_tpu_torch/parallel and the
data-parallel train, BN re-estimation and eval steps).

The world's bookkeeping on one process; then gloo worlds of CPU processes
(tests/torch_dp_common.run_world, a free port each, every result and join
under a deadline) against one process on the same global batch of four
training windows, tiny config, float32, at the JAX package's DP test's
tolerances (tests/test_parallel.py): losses within 1e-5 relative,
parameters and BN state within rtol 2e-4 / atol 2e-6, integer metrics
exactly, and every rank's model equal to rank 0's bit for bit. Then the
world-2 step against the JAX package's step on a 2-device CPU mesh: its
committed record (tests/torch_dp_record.py) at the tolerances of
tests/test_torch_train.py::test_train_step_on_a_batch_matches_jax, and,
``slow``, the live JAX step on every entry."""

import dataclasses

import numpy as np
import pytest
import torch

from insmos_tpu_torch.parallel import (World, all_reduce_grads,
                                       all_reduce_sum, data_world_for_batch,
                                       init_world, rank_device, replicate,
                                       shard_batch)
from insmos_tpu_torch.tools.train_record import LOSSES, sample_indices
from insmos_tpu_torch.utils.params import make_model, to_jax_trees

import torch_dp_common as DP
from torch_dp_record import (dp_inputs, fingerprint, jax_dp_step,
                             load_record, summarize)
from torch_train_common import close, tree_items

RTOL, ATOL = 2e-4, 2e-6  # tests/test_parallel.py


# ---------------------------------------------------------------- the world
def test_world_without_torchrun_is_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    world = init_world("cpu")
    assert world == World() and not world.distributed and world.is_main
    batch = {"x": np.arange(6).reshape(3, 2)}
    np.testing.assert_array_equal(shard_batch(world, batch)["x"], batch["x"])
    t = [torch.ones(3)]
    assert all_reduce_sum(world, t) is t
    lin = torch.nn.Linear(2, 2)
    assert replicate(world, lin) is lin
    lin(torch.ones(1, 2)).sum().backward()
    g = lin.weight.grad.clone()
    all_reduce_grads(world, lin.parameters())
    assert torch.equal(lin.weight.grad, g)
    assert rank_device("cuda") == "cuda" and rank_device("cpu") == "cpu"
    with pytest.raises(ValueError):
        shard_batch(World(0, 2, 2, True), {"x": np.zeros(3)})
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device("cuda") == "cuda:3"
    assert rank_device("cuda:1") == "cuda:1" and rank_device("cpu") == "cpu"


@pytest.mark.parametrize("size,batch,data", [(4, 4, 4), (4, 6, 3), (4, 5, 1),
                                             (4, 8, 4), (3, 4, 2), (1, 3, 1)])
def test_data_world_and_shards(size, batch, data):
    """The largest world that divides the batch; contiguous shards of
    batch / data ranks, empty on the ranks that sit out."""
    b = {"x": np.arange(batch * 2).reshape(batch, 2), "n": np.arange(batch)}
    got = []
    for rank in range(size):
        w = data_world_for_batch(World(rank, size, size, True), batch)
        assert w.data_size == data and w.batch_size == batch
        s = shard_batch(w, b)
        assert len(s["x"]) == (batch // data if rank < data else 0)
        got.append(s["n"])
    np.testing.assert_array_equal(np.concatenate(got), b["n"])
    with pytest.raises(ValueError):
        shard_batch(w, {"x": np.zeros(batch + data)})


# ----------------------------------------------------------- gloo worlds
@pytest.fixture(scope="module")
def inputs():
    _, pcfg, params, state, batch = dp_inputs(DP.SEEDS)
    _, _, _, _, batch2 = dp_inputs((7, 8, 9, 10))
    model = make_model(pcfg, params, state, "cpu")
    return dict(pcfg=pcfg, params=params, state=state, batches=[batch, batch2],
                init={k: v.numpy().copy() for k, v in
                      model.state_dict().items()},
                param_names=[n for n, _ in model.named_parameters()])


@pytest.fixture(scope="module")
def train_runs(inputs):
    """run(size, acc) -> (one process's rows, each rank's rows) of train
    steps at acc_batches ``acc`` (over the first ``acc`` global batches);
    each run is made once per module."""
    cache = {}

    def run(size, acc):
        cfg = inputs["pcfg"]
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, acc_batches=acc))
        args = (cfg, inputs["params"], inputs["state"],
                inputs["batches"][:acc])
        for n in (1, size):
            if (n, acc) not in cache:
                cache[(n, acc)] = DP.run_world(DP.train_job, n, *args)
        return cache[(1, acc)][0], cache[(size, acc)]

    return run


def _same_replicas(ranks):
    for r in ranks[1:]:
        for k, v in ranks[0][-1]["state"].items():
            assert np.array_equal(r[-1]["state"][k], v), k


def _cmp_step(got, ref, cfg, init):
    """One step against the one-process step: losses 1e-5 relative, the
    confusion exactly, the gradients the optimizer saw within RTOL of their
    leaf's largest entry (they are sums of per-sample terms that cancel, in
    another order), the BN state and the parameters within RTOL / ATOL. A
    parameter may differ beyond that
    by what the two gradients' own difference moves Adam's first update,
    lr * u(g + wd p), u(g) = g / (|g| + eps): where a gradient lies within
    a few eps of zero, its last bits (summation order) decide that update
    (one element in 6.5 million on these windows)."""
    for k in LOSSES:
        g, r = float(got["metrics"][k]), float(ref["metrics"][k])
        assert abs(g - r) <= 1e-5 * abs(r), (k, g, r)
    np.testing.assert_array_equal(got["metrics"]["confusion"],
                                  ref["metrics"]["confusion"])
    for k, v in ref["grads"].items():
        close(got["grads"][k], v, RTOL, f"grad {k}")
    lr, wd, eps = cfg.train.lr, cfg.train.weight_decay, 1e-8

    def u(g, p):
        g = g.astype(np.float64) + wd * p
        return g / (np.abs(g) + eps)

    for k, v in ref["state"].items():
        slack = 0.0
        if k in ref["grads"]:
            slack = lr * np.abs(u(got["grads"][k], init[k])
                                - u(ref["grads"][k], init[k]))
        err = np.abs(got["state"][k].astype(np.float64) - v)
        assert (err <= ATOL + RTOL * np.abs(v) + slack).all(), (
            k, float(err.max()))


@pytest.mark.parametrize("size", [2, 3])
def test_dp_step_matches_one_process(inputs, train_runs, size):
    """A world of 2 (two windows a rank) and of 3 (batch 4 splits over 2
    ranks; rank 2 sits out with an empty shard and joins the all-reduces
    with zeros) against one process on the global batch."""
    ref, ranks = train_runs(size, 1)
    assert [r[0]["shard"] for r in ranks] == ([2, 2] if size == 2
                                               else [2, 2, 0])
    _same_replicas(ranks)
    _cmp_step(ranks[0][0], ref[0], inputs["pcfg"], inputs["init"])
    init = inputs["init"]
    moved = [k for k in init if not np.array_equal(ref[0]["state"][k],
                                                   init[k])]
    assert len(moved) > 0.9 * len(init)


def test_dp_grad_accumulation_matches_one_process(inputs, train_runs):
    """acc_batches=2: the first global batch leaves the parameters where
    they were on every rank (the gradients are all-reduced, then
    accumulated), the second updates them as one process does."""
    ref, ranks = train_runs(2, 2)
    init, names = inputs["init"], inputs["param_names"]
    for rows in [ref] + ranks:
        for n in names:
            assert np.array_equal(rows[0]["state"][n], init[n]), n
        assert any(not np.array_equal(rows[1]["state"][n], init[n])
                   for n in names)
    _same_replicas(ranks)
    for i in range(2):
        _cmp_step(ranks[0][i], ref[i], inputs["pcfg"], inputs["init"])


@pytest.fixture(scope="module")
def bn_eval_ref(inputs):
    return DP.run_world(DP.bn_eval_job, 1, inputs["pcfg"], inputs["params"],
                        inputs["state"], inputs["batches"][0])[0]


@pytest.mark.parametrize("size", [2, 3])
def test_dp_bn_reestimate_and_eval_match_one_process(inputs, bn_eval_ref,
                                                     size):
    """A world of 2, and of 3 where rank 2 sits out with an empty shard
    (batch 4 splits over 2 ranks) and joins every collective with zeros of
    the same shapes."""
    args = (inputs["pcfg"], inputs["params"], inputs["state"],
            inputs["batches"][0])
    ref = bn_eval_ref
    ranks = DP.run_world(DP.bn_eval_job, size, *args)
    for r in ranks:
        for k, v in ref["bn"].items():
            np.testing.assert_allclose(r["bn"][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        for k, v in ref["eval"].items():
            if k.startswith("val_"):
                assert abs(float(r["eval"][k]) - float(v)) <= 1e-5 * abs(
                    float(v)), k
            else:
                np.testing.assert_array_equal(r["eval"][k], v, err_msg=k)
    assert int(ref["eval"]["gt"]) > 0 and ref["eval"]["confusion"].sum() > 0


# --------------------------------------------------------- against the JAX
def _cmp_jax(summary, got_rows, pcfg, full_params=None, full_grads=None):
    """The port's world-2 step against the JAX mesh step's summary, at the
    tolerances of test_train_step_on_a_batch_matches_jax: losses 1e-5
    relative, the confusion exactly, parameters after Adam within 1e-6
    where the gradient is above noise (1e-4 of its leaf's largest) and
    within the update's range 2 lr + 1e-6 where it is not, the new BN state
    within 1e-5 x max(1, |v|). With ``full_params``/``full_grads`` (the
    live JAX step) every entry, else the record's sampled ones."""
    row = got_rows[0]
    for k in LOSSES:
        g, r = float(row["metrics"][k]), float(summary[f"loss/{k}"])
        assert abs(g - r) <= 1e-5 * abs(r), (k, g, r)
    np.testing.assert_array_equal(row["metrics"]["confusion"],
                                  summary["confusion"])
    got_p, got_s = to_jax_trees({k: torch.from_numpy(v) for k, v in
                                 row["state"].items()}, pcfg)
    lr = pcfg.train.lr
    n = 0
    for path, p in tree_items(got_p):
        p = np.asarray(p).reshape(-1)
        gmax = float(summary[f"grad_max/{path}"])
        if full_params is None:
            idx = sample_indices(p.size, path)
            ref, g = summary[f"param/{path}"], summary[f"grad/{path}"]
        else:
            idx = slice(None)
            ref = full_params[path].reshape(-1)
            g = full_grads[path].reshape(-1)
        noisy = np.abs(g) <= 1e-4 * max(1.0, gmax)
        err = np.abs(p[idx] - ref)
        assert err[~noisy].max(initial=0) <= 1e-6, path
        assert err[noisy].max(initial=0) <= 2 * lr + 1e-6, path
        n += 1
    assert n > 200
    for path, v in tree_items(got_s):
        close(v, summary[f"state/{path}"], 1e-5, path)


def test_dp_step_matches_jax_record(inputs, train_runs):
    meta, summary = load_record()
    assert meta["seeds"] == list(DP.SEEDS)
    assert meta["fingerprint"] == fingerprint(inputs["params"],
                                              inputs["batches"][0])
    _, ranks = train_runs(2, 1)
    _cmp_jax(summary, ranks[0], inputs["pcfg"])


@pytest.mark.slow
def test_dp_step_matches_jax_mesh_live(inputs, train_runs):
    """The JAX package's mesh step run here (~90 s), every entry."""
    jcfg, *_ = dp_inputs(DP.SEEDS)
    m, after, new_state, grads = jax_dp_step(jcfg, inputs["params"],
                                             inputs["state"],
                                             inputs["batches"][0])
    summary = summarize(m, after, new_state, grads)
    _, ranks = train_runs(2, 1)
    _cmp_jax(summary, ranks[0], inputs["pcfg"], dict(tree_items(after)),
             dict(tree_items(grads)))
