"""Inference CLI (the port of ``insmos_tpu/cli/predict_mos.py``): the same
flags and the same artifact tree.

  python -m insmos_tpu_torch.cli.predict_mos --ckpt <dir> --data_path <root> \
      --split valid|test [--sequences 8 ...] [--out preb_out] [--fixed-frame]

Every scan of each sequence gets mos/.label + confidence/.npy + bbox/.npy
artifacts (utils/io.py); the growing-window warm-up covers the first N-1
scans. ``--pod [--slots_per_device S]`` streams the sequences in
lockstep, S on each device (every visible card unless ``--device`` names
one), and writes the same artifacts. ``--trace PATH`` records the
port's spans and counters (``obs``) over the run and writes their
summary there as JSON. ``--ckpt`` is a port checkpoint
(utils/checkpoint.py). The run is on the card unless ``--device`` names
another device; this flag and ``--trace`` are the only ones the JAX CLI
lacks. Without a checkpoint the weights are random, from
``utils.params.init_params(cfg, numpy.random.default_rng(seed))``: the JAX
CLI draws its own with ``jax.random.PRNGKey(seed)``, which the port cannot
reproduce, so parity between the two always goes through a checkpoint of
the same weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from .. import obs
from ..config import Config
from ..data.kitti import lidar_poses_from_files, load_files, read_point_cloud
from ..data.loader import prefetch_map
from ..pipeline import InferencePipeline, PodInferencePipeline, framed_scans
from ..utils.checkpoint import load_checkpoint
from ..utils.io import artifact_dirs, write_scan_artifacts
from ..utils.params import init_params, make_model

VALID_SEQS = [8]
TEST_SEQS = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="InsMOS inference (PyTorch)")
    p.add_argument("--cfg_file", type=str, default=None, help="config yaml (else ckpt snapshot)")
    p.add_argument("--data_path", type=str, default="demo_data")
    p.add_argument("--ckpt", type=str, default=None, help="checkpoint directory")
    p.add_argument("--split", type=str, default="valid", help="valid or test")
    p.add_argument("--sequences", type=int, nargs="*", default=None)
    p.add_argument("--ext", type=str, default=".bin", help="point cloud file extension")
    p.add_argument("--out", type=str, default="preb_out")
    p.add_argument("--seed", type=int, default=0, help="init seed when no ckpt")
    p.add_argument(
        "--pod", action="store_true",
        help="stream sequences in lockstep, slots_per_device streams on "
        "each device (pod inference; every visible card, or --device)",
    )
    p.add_argument(
        "--slots_per_device", type=int, default=1,
        help="with --pod: sequence streams per device",
    )
    p.add_argument(
        "--allow-default", action="store_true", dest="allow_default",
        help="permit a ckpt-less, cfg-less run (random weights at the "
        "full-scale default Config)",
    )
    p.add_argument(
        "--fixed-frame", action="store_true", dest="fixed_frame",
        help="fixed-odometry framing + incremental stem reuse: scans are "
        "expressed in a fixed-orientation voxel-snapped frame so the "
        "device window shifts by integer voxels and the stem's outputs "
        "are reused across steps (the scene keeps odometry orientation "
        "instead of the reference's per-step re-rotation)",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument(
        "--trace", type=str, default=None, metavar="PATH",
        help="record the port's spans and counters (insmos_tpu_torch.obs) "
        "over the run and write their summary to PATH as JSON",
    )
    return p.parse_args(argv)


def build_model(args):
    """(cfg, model) from ``--ckpt`` and ``--cfg_file`` as the JAX CLI
    resolves them, the model on ``--device``."""
    if args.ckpt:
        cfg = Config.from_yaml(args.cfg_file) if args.cfg_file else None
        cfg, model, _ = load_checkpoint(args.ckpt, args.device, cfg)
        return cfg, model
    if not args.cfg_file and not args.allow_default:
        raise SystemExit(
            "predict_mos: no --ckpt and no --cfg_file — this would run "
            "RANDOM weights at the full-scale default config. Pass "
            "--cfg_file (or --ckpt), or force with --allow-default."
        )
    cfg = Config.from_yaml(args.cfg_file) if args.cfg_file else Config()
    params, state = init_params(cfg, np.random.default_rng(args.seed))
    return cfg, make_model(cfg, params, state, args.device)


def _sequence_inputs(args, cfg, seq):
    """(scan files, lidar poses or None) of one sequence."""
    seq_dir = os.path.join(args.data_path, f"{int(seq):02d}")
    files = [f for f in load_files(os.path.join(seq_dir, "velodyne"))
             if f.endswith(args.ext)]
    poses = None
    if cfg.data.transform:
        poses = lidar_poses_from_files(
            os.path.join(seq_dir, cfg.data.poses_file),
            os.path.join(seq_dir, "calib.txt"))
    return files, poses


def _run_pod(args, cfg, model, sequences) -> dict:
    """Streaming multi-sequence pod inference: the sequences in waves of
    S = n_slots, one scan per sequence per step, a slot idle once its
    sequence has ended. Each slot reads and frames its sequence as the
    serial run does (prefetched reads, ``pipeline.framed_scans``; with
    --fixed-frame the incremental stem streams in every slot), and each
    pod step is queued before the previous step's outputs are fetched.
    Each slot writes the serial run's artifacts."""
    devices = None if args.device == "cuda" else [args.device]
    pipe = PodInferencePipeline(cfg, model, devices,
                                max(1, int(args.slots_per_device)))
    S = pipe.n_slots
    vox = cfg.data.voxel_size[0]
    stats = {"scans": 0, "seconds": 0.0, "waves": []}
    for w0 in range(0, len(sequences), S):
        wave = sequences[w0:w0 + S]
        inputs = [_sequence_inputs(args, cfg, seq) for seq in wave]
        dirs = [artifact_dirs(args.out, cfg.experiment_id, seq)
                for seq in wave]
        n_steps = max(len(files) for files, _ in inputs)
        pipe.reset()
        t0 = time.perf_counter()
        streams = [framed_scans(prefetch_map(
            read_point_cloud, files, num_workers=cfg.data.num_workers),
            poses, args.fixed_frame, vox) for files, poses in inputs]
        prev = None
        for t in range(n_steps):
            scans, tfs = [None] * S, [None] * S
            for i, stream in enumerate(streams):
                scans[i], tfs[i] = next(stream, (None, None))
            out = pipe.push_scans(scans, tfs)
            if prev is not None:
                _write_pod_step(pipe, dirs, *prev)
            prev = (t, out, [None if sc is None else len(sc)
                             for sc in scans])
        if prev is not None:
            _write_pod_step(pipe, dirs, *prev)
        dt = time.perf_counter() - t0
        n_scans = sum(len(files) for files, _ in inputs)
        stats["scans"] += n_scans
        stats["seconds"] += dt
        stats["waves"].append({"sequences": [int(q) for q in wave],
                               "scans": n_scans, "seconds": dt})
        print(f"pod wave {wave}: {n_scans} scans in {dt:.1f}s "
              f"({n_scans / max(dt, 1e-9):.2f} scans/s aggregate)")
    return stats


def _write_pod_step(pipe, dirs, t, out, n_raw):
    """Step ``t``'s artifacts for every slot that stepped (``n_raw`` its
    scan's point count, None where the slot idled)."""
    for i, d in enumerate(dirs):
        if n_raw[i] is not None:
            o = pipe.fetch(out, i, n_raw[i])
            write_scan_artifacts(d, t, o["point_logits"], o["boxes"],
                                 o["scores"], o["labels"])


def run(args) -> dict:
    cfg, model = build_model(args)

    sequences = args.sequences
    if sequences is None:
        sequences = VALID_SEQS if args.split == "valid" else TEST_SEQS

    if args.fixed_frame:
        cfg = dataclasses.replace(
            cfg,
            runtime=dataclasses.replace(cfg.runtime, incremental_stem=True),
        )

    if args.pod:
        return _run_pod(args, cfg, model, list(sequences))

    pipe = InferencePipeline(cfg, model, args.device)
    stats = {"scans": 0, "seconds": 0.0, "per_sequence": []}
    for seq in sequences:
        files, poses = _sequence_inputs(args, cfg, seq)
        dirs = artifact_dirs(args.out, cfg.experiment_id, seq)
        full0 = pipe.n_full_steps
        t0 = time.perf_counter()
        scan_iter = prefetch_map(
            read_point_cloud, files, num_workers=cfg.data.num_workers
        )
        for idx, out in enumerate(
            pipe.stream_sequence(scan_iter, poses, fixed_frame=args.fixed_frame)
        ):
            write_scan_artifacts(
                dirs, idx, out["point_logits"], out["boxes"], out["scores"], out["labels"]
            )
        dt = time.perf_counter() - t0
        stats["scans"] += len(files)
        stats["seconds"] += dt
        stats["per_sequence"].append(
            {"sequence": int(seq), "scans": len(files), "seconds": dt,
             "n_full_steps": pipe.n_full_steps - full0})
        print(f"seq {seq:02d}: {len(files)} scans in {dt:.1f}s "
              f"({len(files) / max(dt, 1e-9):.2f} scans/s)")
    return stats


def main(argv=None):
    args = parse_args(argv)
    if args.trace is None:
        return run(args)
    obs.reset()
    with obs.tracing():
        stats = run(args)
    with open(args.trace, "w") as fh:
        json.dump(obs.summary(), fh, indent=1)
    return stats


if __name__ == "__main__":
    main()
