"""The JAX package's record for the port's train-step parity check.

    JAX_PLATFORMS=cpu python tests/torch_train_record.py [--out PATH]

Takes one float32 train step of the JAX package on the CPU (its windowed
engine: jax.value_and_grad of train/step.sample_losses, then one update of
its optax optimizer) on ``insmos_tpu_torch.tools.train_record``'s window,
weights and configuration, and writes the step's summary
(``train_record.summarize``) to ``tests/torch_goldens/train_record.npz``
by default, beside the same step of the port's CPU route. ``chip_smoke.py``
holds the port's step on the card against both; tests/test_torch_train_record.py runs the same functions at a tiny
size. The port cannot import this file: it imports jax. XLA's
concurrency-optimised CPU scheduler is turned off, as in
tests/torch_stream_record.py (it keeps every conv's window probes alive at
once; the schedule changes no value).
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from insmos_tpu_torch.tools import train_record as TR  # noqa: E402


def jax_summary(cfg, params, state, sample) -> dict:
    """One JAX train step (batch 1) at the port Config ``cfg``'s values,
    from numpy trees: its summary."""
    import jax
    import optax

    from insmos_tpu.config import Config as JaxConfig
    from insmos_tpu.nn import InsMOSModel
    from insmos_tpu.train.optim import make_optimizer
    from insmos_tpu.train.step import sample_losses

    jcfg = JaxConfig.from_dict(cfg.to_dict())
    model = InsMOSModel(jcfg)

    def lf(p, s, x):
        total, aux, out = sample_losses(model, p, s, x, train=True)
        return total, (aux, {k: out[k] for k in ("boxes", "box_mask")})

    (_, (aux, out)), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        params, state, sample)
    tx = make_optimizer(jcfg, TR.STEPS_PER_EPOCH)
    upd, _ = tx.update(grads, tx.init(params), params)
    after = optax.apply_updates(params, upd)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    aux = np_(aux)
    return TR.summarize({k: float(aux[k]) for k in TR.LOSSES},
                        aux["confusion"], np.asarray(out["boxes"]),
                        np.asarray(out["box_mask"]), np_(grads), np_(after),
                        aux["new_state"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / TR.RECORD))
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_cpu_enable_concurrency_optimized_scheduler=false").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg = TR.record_config()
    sample = TR.record_sample(cfg)
    params, state = TR.record_params(cfg)
    t0 = time.perf_counter()
    summary = jax_summary(cfg, params, state, sample)
    seconds = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    port = TR.port_summary(cfg, params, state, sample, "cpu")
    fails, read = TR.compare(summary, port, cfg.train.lr,
                             TR.TOLERANCES["jax"])
    print(f"the port's CPU route against the JAX step: {read}")
    assert not fails, fails
    TR.save_record(args.out, cfg, {"jax": summary, "port_cpu": port},
                   jax=jax.__version__,
                   inputs=TR.fingerprint(sample, params),
                   seconds_cpu=seconds, peak_rss_gib=peak,
                   tolerances=TR.TOLERANCES)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{seconds:.1f} s on the CPU, peak resident set {peak:.1f} GiB; "
          f"losses { {k: float(summary['loss/' + k]) for k in TR.LOSSES} }, "
          f"{len(summary['boxes'])} kept boxes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
