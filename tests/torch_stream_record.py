"""The JAX package's record for the port's stream parity check.

    JAX_PLATFORMS=cpu python tests/torch_stream_record.py [--out PATH]

Writes the two HDL-64E fixture sequences of
``insmos_tpu_torch.tools.stream_record`` (the ref-exact stream, and the
straight-ego stream that ``--fixed-frame`` frames itself) in KITTI format,
saves the numpy weights ``init_params(cfg, numpy.random.default_rng(0))``
as an orbax checkpoint, runs the JAX package's ``predict_mos`` over each
sequence exactly as a user would (``--fixed-frame`` on the second), on the
CPU with its ``auto`` engine, at the full default Config in float32, and
condenses each step (``stream_record.summarize``) into the record,
``tests/torch_goldens/stream_record.npz`` by default. ``chip_smoke.py``
holds the port's ``predict_mos`` on the card against it;
tests/test_torch_stream_record.py runs the same functions at a tiny size.
The port cannot import this file: it imports jax.

    JAX_PLATFORMS=cpu python tests/torch_stream_record.py --weights calibrated

writes the calibrated record, ``tests/torch_goldens/
stream_record_calibrated.npz``, the same way from the weights of
``stream_record.calibrated_params`` (BN running statistics set from data,
the committed ``calibrated_state.npz``; the class head's bias and scale),
under which the heatmap follows the scan and a few dozen candidates pass
the score gate. Each step also keeps the logits of points inside its kept
boxes, each kept box's margin and the number of gated candidates
(``stream_record.summarize_calibrated``); the record's ``meta`` keeps the
recipe's constants, a fingerprint of the weights, and per step the
largest change of a heatmap logit, the gated count and whether the kept
set changed.

XLA's CPU backend schedules the MotionNet step for concurrency by default,
which keeps the window tables' one-hot probes of every conv alive at once:
60 GiB of temporaries at the full Config. ``main`` turns that scheduler
off (``XLA_FLAGS``, before jax is imported), which leaves 3.4 GiB. The
schedule orders the same operations differently and changes no value.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from insmos_tpu_torch.tools import stream_record as SR  # noqa: E402
from insmos_tpu_torch.utils.params import init_params  # noqa: E402


def jax_maps(pipeline_cls):
    """The JAX package's ``pipeline_cls`` whose step outputs also carry
    the head's dense class and box maps (``cls_map``, ``box_map``)."""

    class WithMaps(pipeline_cls):
        def _step_tail(self, params, state, inter):
            out = self.model.forward_tail(params, state, inter, train=False)
            return {k: out[k] for k in (
                "point_logits", "boxes", "scores", "labels", "box_mask",
                "overflow", "cls_map", "box_map")}

    return WithMaps


def jax_record(cfg, workdir: str, n_scans: int = SR.N_SCANS,
               seed: int = 0, trees=None) -> dict[str, list[dict]]:
    """Writes both sequences under ``workdir``, runs the JAX predict_mos
    over each and returns {sequence name: summarize rows}. ``cfg`` is the
    port's Config; the JAX package runs the same values. The weights are
    ``init_params(cfg, default_rng(0))``, or with ``trees`` those
    (params, state) numpy trees, summarized as the calibrated record
    (``summarize_calibrated``)."""
    from insmos_tpu.cli import predict_mos
    from insmos_tpu.config import Config as JaxConfig
    from insmos_tpu.utils.checkpoint import save_checkpoint

    root = os.path.join(workdir, "kitti")
    out = os.path.join(workdir, "preb_out")
    ckpt = os.path.join(workdir, "ckpt")
    SR.write_sequences(root, cfg, n_scans, seed)
    params, state = trees or init_params(cfg, np.random.default_rng(0))
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    save_checkpoint(ckpt, jcfg, params, state)
    record = {}
    for name, (seq, fixed) in SR.SEQUENCES.items():
        with SR.capturing(predict_mos, jax_maps if trees else None) as steps:
            predict_mos.main(
                ["--ckpt", ckpt, "--data_path", root, "--sequences",
                 str(seq), "--out", out] + (["--fixed-frame"] if fixed else []))
        pred_root = os.path.join(out, jcfg.experiment_id)
        record[name] = (SR.summarize_calibrated(cfg, steps, pred_root, seq)
                        if trees else SR.summarize(steps, pred_root, seq))
    return record


def calibrated_meta(record, params, state) -> dict:
    """The calibrated record's recipe, weights and per-step readings: the
    largest change of a heatmap logit from the previous step, the gated
    candidates, and whether the kept set differs from the previous
    step's."""
    meta = dict(weights="calibrated", cls_bias=SR.CLS_BIAS,
                cls_scale=SR.CLS_SCALE, state=SR.CALIBRATED_STATE,
                fingerprint=SR.fingerprint(params, state))
    for name, rows in record.items():
        meta[f"{name}/heat_change"] = [float(r["heat_change"]) for r in rows]
        meta[f"{name}/n_gated"] = [int(r["n_gated"]) for r in rows]
        meta[f"{name}/kept_changed"] = [None] + [
            not (np.array_equal(a["boxes"], b["boxes"])
                 and np.array_equal(a["scores"], b["scores"]))
            for a, b in zip(rows, rows[1:])]
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", choices=("init", "calibrated"),
                    default="init")
    ap.add_argument("--out", default=None,
                    help="default: the record of --weights under "
                    "tests/torch_goldens")
    ap.add_argument("--scans", type=int, default=SR.N_SCANS)
    args = ap.parse_args(argv)
    calibrated = args.weights == "calibrated"
    args.out = args.out or str(REPO / (SR.RECORD_CALIBRATED if calibrated
                                       else SR.RECORD))
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_cpu_enable_concurrency_optimized_scheduler=false").strip()
    import jax

    from insmos_tpu_torch.config import Config

    jax.config.update("jax_platforms", "cpu")
    cfg = Config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype="float32"))
    t0 = time.perf_counter()
    trees = SR.calibrated_params(cfg) if calibrated else None
    with tempfile.TemporaryDirectory() as tmp:
        record = jax_record(cfg, tmp, args.scans, trees=trees)
    seconds = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    meta = calibrated_meta(record, *trees) if calibrated else {}
    SR.save_record(args.out, cfg, record, n_scans=args.scans, seed=0,
                   jax=jax.__version__, seconds_cpu=seconds,
                   peak_rss_gib=peak, **meta)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes): "
          f"{args.scans} scans per sequence in {seconds:.1f} s on the CPU, "
          f"peak resident set {peak:.1f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
