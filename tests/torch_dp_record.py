"""The JAX package's data-parallel train step, recorded for the port's DP
parity test.

    JAX_PLATFORMS=cpu python tests/torch_dp_record.py [--out PATH]

Runs one float32 train step of the JAX package on a 2-device CPU mesh
(``parallel.make_mesh(2)``, the state replicated, the global batch of four
training windows sharded: ``tests/torch_dp_common.SEEDS``), and the mean of
its per-sample gradients, at the tiny config of tests/test_torch_train.py
with ``tools.train_record.record_params`` weights. Writes
``tests/torch_goldens/dp_record.npz`` by default: the mean losses, the
confusion matrix, the new BN state, and per parameter leaf the largest
|gradient| with the gradient and the parameter after the update at the
entries ``tools.train_record.sample_indices`` picks, beside a fingerprint
of the inputs. tests/test_torch_parallel.py holds the port's world-2 gloo
step against it (the JAX step alone takes ~90 s on an 8-core CPU, so the
live comparison is a ``slow`` test). The port cannot import this file: it
imports jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
for p in (REPO, TESTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

RECORD = TESTS / "torch_goldens" / "dp_record.npz"


def dp_inputs(seeds):
    """(JAX config, port config, params, state, global batch) of the
    record: tiny config, window 3, 1024 points a scan, float32."""
    from insmos_tpu_torch.tools.train_record import record_params
    from test_torch_model import port_config
    from torch_port_common import hdl64_crop_stream, tiny_config
    from torch_train_common import stack, train_window

    cfg = tiny_config(window=3, points=1024)
    pcfg = port_config(cfg)
    params, state = record_params(pcfg)
    samples = []
    for seed in seeds:
        scans, _, _ = hdl64_crop_stream(3, seed=seed, max_points=1024)
        samples.append(train_window(pcfg, scans, seed))
    return cfg, pcfg, params, state, stack(samples)


def fingerprint(params, batch) -> dict:
    from torch_train_common import tree_items

    return {"points": float(batch["points"].astype(np.float64).sum()),
            "labels": int(batch["labels"].sum()),
            "params": float(sum(v.astype(np.float64).sum()
                                for _, v in tree_items(params)))}


def jax_dp_step(cfg, params, state, batch):
    """The JAX step on a 2-device mesh and the mean per-sample gradient:
    (metrics, params after, new state, mean gradients) as numpy trees."""
    import jax
    import jax.numpy as jnp

    from insmos_tpu.nn import InsMOSModel
    from insmos_tpu.parallel import make_mesh, replicate, shard_batch
    from insmos_tpu.train import TrainState, make_train_step
    from insmos_tpu.train import step as jstep
    from insmos_tpu.train.optim import make_optimizer

    model = InsMOSModel(cfg)
    tx = make_optimizer(cfg, 10)
    mesh = make_mesh(2)
    ts = TrainState(replicate(mesh, params), replicate(mesh, state),
                    replicate(mesh, tx.init(params)),
                    jnp.zeros((), jnp.int32))
    ts, m = make_train_step(model, tx)(ts, shard_batch(mesh, batch))

    def lf(p, s, x):
        return jstep.sample_losses(model, p, s, x, train=True)[0]

    vg = jax.jit(jax.grad(lf))
    B = len(batch["points"])
    grads = [vg(params, state, {k: v[i] for k, v in batch.items()})
             for i in range(B)]
    mean = jax.tree_util.tree_map(lambda *g: sum(g) / B, *grads)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(m), to_np(ts.params), to_np(ts.state), to_np(mean)


def summarize(metrics, params_after, new_state, grads) -> dict:
    from insmos_tpu_torch.tools.train_record import LOSSES, sample_indices
    from torch_train_common import tree_items

    out = {f"loss/{k}": np.float32(metrics[k]) for k in LOSSES}
    out["confusion"] = np.asarray(metrics["confusion"], np.int64)
    after = dict(tree_items(params_after))
    for path, g in tree_items(grads):
        g = np.asarray(g, np.float32)
        idx = sample_indices(g.size, path)
        out[f"grad_max/{path}"] = np.float32(np.abs(g).max())
        out[f"grad/{path}"] = g.reshape(-1)[idx]
        out[f"param/{path}"] = np.asarray(after[path]).reshape(-1)[idx]
    for path, v in tree_items(new_state):
        out[f"state/{path}"] = np.asarray(v, np.float32)
    return out


def load_record(path=RECORD):
    """(meta, summary) of a record file."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        return meta, {k: z[k] for k in z.files if k != "meta"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(RECORD))
    args = ap.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()
    import jax

    from torch_dp_common import SEEDS

    jax.config.update("jax_platforms", "cpu")
    cfg, _, params, state, batch = dp_inputs(SEEDS)
    t0 = time.perf_counter()
    summary = summarize(*jax_dp_step(cfg, params, state, batch))
    seconds = time.perf_counter() - t0
    meta = dict(seeds=list(SEEDS), fingerprint=fingerprint(params, batch),
                jax=jax.__version__, seconds_cpu=seconds)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, meta=np.array(json.dumps(meta)), **summary)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
