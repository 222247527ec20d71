"""The JAX package's span-plan coverage counters on the streams that
``chip_smoke.py``'s ``phase_pod`` gates.

    JAX_PLATFORMS=cpu python tests/torch_plan_record.py [--out PATH]

Runs the JAX package's ``InferencePipeline`` on the CPU at the full default
Config with its span engine forced (``runtime.sparse_engine="span"``, the
engine it deploys on an accelerator) over the port's streams:
``data.hdl64.make_stream`` seeds 0-3 (20 scans, ref-exact; the pod's
S = 1, 2, 4 readings run these) and ``make_fixed_frame_stream`` seeds 0-1
(13 scans, the incremental mode). Each step's ``span_overflow`` per plan
(rows a plan's span and greedy coverage leave uncovered) and its capacity
drops go to ``tests/torch_goldens/plan_record.json`` by default.
``phase_pod`` holds the port's counters on the card equal to these, step
for step.

The span kernels are not run: for the run, ``span_conv_parts`` is
replaced by zeros of its output shape. A plan and its counter are a
function of the site sets, which the coordinates alone decide (features
and weights never reach a plan), so the counters are those of the full
step; the kernels would otherwise run in Pallas interpret mode. XLA's
concurrency-optimized CPU scheduler is turned off as in
tests/torch_stream_record.py. The port cannot import this file: it imports
jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

RECORD = REPO / "tests" / "torch_goldens" / "plan_record.json"
# (mode, seeds, scans): the streams phase_pod runs
STREAMS = (("ref-exact", (0, 1, 2, 3), 20), ("fixed-frame", (0, 1), 13))


def _no_conv(x_keys, feats_cat, weights, parts, out_coords, out_valid, plan,
             T_out):
    """``span_conv_parts``'s output shape, all zeros."""
    import jax.numpy as jnp

    TO = max(pt.out_off + T_out * pt.cout for pt in parts)
    return jnp.zeros((out_coords.shape[0], TO), jnp.float32)


def streams(cfg, mode: str, seed: int, n: int):
    """(scans, tfs) of one of the port's streams."""
    from insmos_tpu_torch.data.hdl64 import (make_fixed_frame_stream,
                                             make_stream)

    if mode == "fixed-frame":
        scans, tfs, _ = make_fixed_frame_stream(cfg, n, seed=seed)
        return scans, tfs
    return make_stream(cfg, n, seed=seed)


def jax_counters(cfg, mode: str, scans, tfs) -> list[dict]:
    """Per step, the JAX package's span_overflow per plan and capacity
    drops, its span engine forced and its kernels replaced by zeros.
    ``cfg`` is the port's Config; the JAX package runs the same values."""
    from insmos_tpu.config import Config as JaxConfig
    from insmos_tpu.pipeline import InferencePipeline
    from insmos_tpu.sparse import span_conv
    from insmos_tpu_torch.utils.params import init_params

    jcfg = JaxConfig.from_dict(cfg.to_dict())
    jcfg = dataclasses.replace(jcfg, runtime=dataclasses.replace(
        jcfg.runtime, sparse_engine="span", compute_dtype="float32",
        incremental_stem=mode == "fixed-frame"))
    params, state = init_params(cfg, np.random.default_rng(0))
    orig = span_conv.span_conv_parts
    span_conv.span_conv_parts = _no_conv
    try:
        pipe = InferencePipeline(jcfg, params, state)
        pipe.reset()
        rows = []
        for scan, tf in zip(scans, tfs):
            ovf = {k: np.asarray(v) for k, v in
                   pipe.push_scan(scan, tf)["overflow"].items()}
            rows.append(dict(
                span_overflow=[int(v) for v in ovf["span_overflow"]],
                dropped=int(ovf["motion_dropped"].sum() + ovf["unet_dropped"]
                            + ovf["voxelizer_capacity_dropped"])))
    finally:
        span_conv.span_conv_parts = orig
    return rows


def load_record(path=RECORD) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(RECORD))
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_cpu_enable_concurrency_optimized_scheduler=false").strip()
    import jax

    from insmos_tpu_torch.config import Config

    jax.config.update("jax_platforms", "cpu")
    cfg = Config()
    t0 = time.perf_counter()
    record = {"jax": jax.__version__, "config": "Config()",
              "weights": "init_params(cfg, default_rng(0))", "streams": {}}
    for mode, seeds, n in STREAMS:
        for seed in seeds:
            rows = jax_counters(cfg, mode, *streams(cfg, mode, seed, n))
            record["streams"][f"{mode}/{seed}"] = rows
            print(f"{mode} seed {seed}: " + json.dumps(
                {t: r["span_overflow"] for t, r in enumerate(rows)
                 if any(r["span_overflow"]) or r["dropped"]}), flush=True)
    record["seconds_cpu"] = time.perf_counter() - t0
    record["peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}: {record['seconds_cpu']:.1f} s on the CPU, "
          f"peak resident set {record['peak_rss_gib']:.1f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
