"""The rows that overflowing span plans leave uncovered, held row for row
against the JAX package's span kernel.

    JAX_PLATFORMS=cpu python tests/torch_overflow_record.py [--out PATH]
        [--only NAME ...]

Streams seed 0's two fixture streams through the port's InferencePipeline
on the CPU (the span engine through its plain version,
``sparse/span_conv.span_conv_parts_plain``) at the full default Config in
float32 with the calibrated record's weights
(``tools/stream_record.calibrated_params``): the ref-exact stream
(``data/hdl64.make_stream``, steps 0-19) and the fixed-frame stream
through the incremental mode (``make_fixed_frame_stream``, steps 0-8). It
captures the inputs of every span conv whose plan reports ``n_overflow >
0`` (``x_keys``, ``feats_cat``, the weights, the parts, the output sites,
``T_out`` and the plan's request). On seed 0 these are the plans
``tools/validate_plan_budgets`` names: block L2 at ref-exact step 3,
decoder L1 at ref-exact step 5, decoder L2 at ref-exact full-window steps
15-19 and at fixed-frame step 5, and the stem-scan and decoder L1 plans at
fixed-frame step 8.

On each captured conv it runs the JAX package's
``make_span_plan(..., exact_stats=True)`` and ``span_conv_parts`` (its
Pallas kernels in interpret mode on the CPU) and the port's
``make_span_plan(..., exact_stats=True)`` and ``span_conv_parts_plain``,
and compares every output row (``TOL``), the rows with uncovered taps
(``span_conv.uncovered_rows``) among them, and the exact uncovered counts
(integers, equal). It writes a small JSON golden,
``tests/torch_goldens/overflow_record.json`` by default: per conv its
plan, shape, exact count, the largest differences over all rows and over
the uncovered ones, and float64 sums of the JAX output (``sum``,
``abs_sum``), which ``chip_smoke.py`` holds the card's kernels against.
XLA's concurrency-optimized CPU scheduler is turned off as in
tests/torch_stream_record.py. The port cannot import this file: it
imports jax.
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

from insmos_tpu_torch.tools import overflow_plans as OP  # noqa: E402

# |port - JAX| <= TOL * max(1, |JAX|) on every row: both sum the same
# float32 products in another order (as tests/test_torch_span_conv.py)
TOL = 1e-4


def jax_conv(args, exact: bool = True):
    """The JAX package's exact plan and span_conv_parts (interpret mode)
    on one captured conv. Returns (its output, its exact uncovered
    count)."""
    import jax.numpy as jnp

    from insmos_tpu.sparse import span_conv as jsc

    x_keys, feats_cat, weights, parts, oc, ov, plan, T_out = args

    def j(t):
        return jnp.asarray(t.cpu().numpy())

    jplan = jsc.make_span_plan(j(x_keys), j(oc), j(ov), exact_stats=exact,
                               **OP.request_of(plan))
    out = jsc.span_conv_parts(
        j(x_keys), j(feats_cat), [j(w) for w in weights],
        tuple(jsc.ConvPart(**dataclasses.asdict(p)) for p in parts),
        j(oc), j(ov), jplan, T_out)
    return np.asarray(out), int(jplan.n_overflow)


def compare_conv(args) -> dict:
    """One captured conv: the JAX package's against the port's, row for
    row."""
    t0 = time.perf_counter()
    ref, n_jax = jax_conv(args)
    seconds = time.perf_counter() - t0
    got, n_port, rows = OP.port_conv(args)
    e = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    e_rows = e.max(1)
    return dict(
        shape=list(ref.shape), exact_uncovered=n_jax,
        exact_uncovered_port=n_port, uncovered_rows=int(rows.sum()),
        max_rel=float(e_rows.max()),
        max_rel_uncovered=float(e_rows[rows].max(initial=0.0)),
        max_abs=float(np.abs(got - ref).max()),
        sum=float(ref.astype(np.float64).sum()),
        abs_sum=float(np.abs(ref.astype(np.float64)).sum()),
        port_sum=float(got.astype(np.float64).sum()),
        jax_seconds_cpu=seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / OP.RECORD))
    ap.add_argument("--only", nargs="*", default=None,
                    help="names of the convs to run (default: all)")
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_cpu_enable_concurrency_optimized_scheduler=false").strip()
    import jax

    from insmos_tpu_torch.config import Config
    from insmos_tpu_torch.tools import stream_record as SR

    jax.config.update("jax_platforms", "cpu")
    cfg = Config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype="float32"))
    params, state = SR.calibrated_params(cfg)
    t0 = time.perf_counter()
    record = dict(jax=jax.__version__, config="Config() float32",
                  weights="stream_record.calibrated_params",
                  fingerprint=SR.fingerprint(params, state), tol=TOL,
                  convs={})
    failures = []
    for stream, n_steps in OP.STREAMS:
        if args.only is not None and not any(
                n.startswith(stream + "/") for n in args.only):
            continue
        caps = OP.capture(cfg, stream, n_steps, params, state, "cpu")
        for name, conv in caps.items():
            if args.only is not None and name not in args.only:
                continue
            r = compare_conv(conv)
            record["convs"][name] = r
            print(f"{name}: {json.dumps(r)}", flush=True)
            if r["exact_uncovered"] != r["exact_uncovered_port"] \
                    or not r["exact_uncovered"] or r["max_rel"] > TOL:
                failures.append(name)
        del caps
    record["seconds_cpu"] = time.perf_counter() - t0
    record["peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}: {len(record['convs'])} convs in "
          f"{record['seconds_cpu']:.1f} s on the CPU, peak resident set "
          f"{record['peak_rss_gib']:.1f} GiB; failures {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
