"""Inference CLI (the port of ``insmos_tpu/cli/predict_mos.py``): the same
flags and the same artifact tree.

  python -m insmos_tpu_torch.cli.predict_mos --ckpt <dir> --data_path <root> \
      --split valid|test [--sequences 8 ...] [--out preb_out] [--fixed-frame]

Every scan of each sequence gets mos/.label + confidence/.npy + bbox/.npy
artifacts (utils/io.py); the growing-window warm-up covers the first N-1
scans. ``--ckpt`` is a port checkpoint (utils/checkpoint.py). The run is on
the card unless ``--device`` names another device; this flag is the only
one the JAX CLI lacks. Without a checkpoint the weights are random, from
``utils.params.init_params(cfg, numpy.random.default_rng(seed))``: the JAX
CLI draws its own with ``jax.random.PRNGKey(seed)``, which the port cannot
reproduce, so parity between the two always goes through a checkpoint of
the same weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from ..config import Config
from ..data.kitti import lidar_poses_from_files, load_files, read_point_cloud
from ..data.loader import prefetch_map
from ..pipeline import InferencePipeline
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
        help="stream sequences in lockstep, one per device (not ported "
        "yet: exits with an error)",
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


def run(args) -> dict:
    if args.pod:
        raise SystemExit(
            "predict_mos: --pod (multi-device pod inference) is not ported "
            "yet; it waits for data parallelism (ROADMAP Queue 1 item 6)."
        )
    cfg, model = build_model(args)

    sequences = args.sequences
    if sequences is None:
        sequences = VALID_SEQS if args.split == "valid" else TEST_SEQS

    if args.fixed_frame:
        cfg = dataclasses.replace(
            cfg,
            runtime=dataclasses.replace(cfg.runtime, incremental_stem=True),
        )

    pipe = InferencePipeline(cfg, model, args.device)
    stats = {"scans": 0, "seconds": 0.0, "per_sequence": []}
    for seq in sequences:
        seq_dir = os.path.join(args.data_path, f"{int(seq):02d}")
        files = [
            f
            for f in load_files(os.path.join(seq_dir, "velodyne"))
            if f.endswith(args.ext)
        ]
        poses = None
        if cfg.data.transform:
            poses = lidar_poses_from_files(
                os.path.join(seq_dir, cfg.data.poses_file),
                os.path.join(seq_dir, "calib.txt"),
            )
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
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
