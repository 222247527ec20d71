"""Does the float32 route of ``predict_mos`` repeat from run to run?

    python -m insmos_tpu_torch.tools.repeat_check [--device cpu] [--out PATH]

Writes both fixture sequences of ``tools/stream_record.py`` at the full
default Config, saves a port checkpoint of ``init_params(cfg, rng(0))`` in
float32, and runs ``predict_mos`` twice over each, three ways: as the port
is; with the voxel mean summed by a float ``index_add_`` (the sum it
replaced, whose atomic adds on CUDA sum in another order on every run); and
with that sum under ``torch.use_deterministic_algorithms(True)``. Prints per
way and sequence the largest point-logit change between the two runs at
each step, the number of steps whose kept boxes changed, and whether the
runs are equal bit for bit; ``--out`` writes them as JSON. Runs on the card
unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from ..cli import predict_mos
from ..config import Config
from ..nn import model as model_mod
from ..sparse import voxelize
from ..utils.checkpoint import save_checkpoint_from_trees
from ..utils.params import init_params
from . import stream_record as SR


def index_add_voxelize_points(points, point_valid, pc_range, voxel_size,
                              dims, capacity, max_points_per_voxel):
    """``voxelize.voxelize_points`` with the voxel sums taken by a float
    ``index_add_``, as the port took them before."""
    dev = points.device
    inv = 1.0 / torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=dev)
    vox_coord = torch.floor((points[:, :3] - lo) * inv).to(torch.int32)
    sites, p2v, slot, counts = voxelize.unique_voxels(
        vox_coord, dims, capacity, point_valid, first_occurrence_cap=True)
    in_mean = (p2v >= 0) & (slot < max_points_per_voxel)
    seg = torch.where(in_mean, p2v, capacity).to(torch.int64)
    feat_sum = torch.zeros((capacity + 1, points.shape[1]),
                           dtype=points.dtype, device=dev)
    feat_sum.index_add_(0, seg, torch.where(in_mean[:, None], points, 0.0))
    denom = torch.clamp(torch.clamp(counts, max=max_points_per_voxel),
                        min=1).to(points.dtype)
    return sites.replace_feats(feat_sum[:capacity] / denom[:, None]), p2v


WAYS = {
    "slot-ordered sum": (voxelize.voxelize_points, False),
    "index_add_": (index_add_voxelize_points, False),
    "index_add_, deterministic algorithms": (index_add_voxelize_points, True),
}


@contextlib.contextmanager
def voxel_sum(fn, deterministic: bool):
    """Within the block the model voxelizes with ``fn``, and torch's
    deterministic algorithms are on when ``deterministic``."""
    orig = model_mod.voxelize_points
    was = torch.are_deterministic_algorithms_enabled()
    model_mod.voxelize_points = fn
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        yield
    finally:
        model_mod.voxelize_points = orig
        torch.use_deterministic_algorithms(was)


def run_once(ckpt, root, out, seq, fixed, device):
    """One predict_mos run over one sequence: per step, its point logits,
    boxes and kept-box mask on the host."""
    argv = ["--ckpt", ckpt, "--data_path", root, "--sequences", str(seq),
            "--out", out, "--device", device] + (
                ["--fixed-frame"] if fixed else [])
    with SR.capturing(predict_mos) as steps:
        predict_mos.main(argv)
    return [(o["point_logits"][:n].cpu(), o["boxes"].cpu(),
             o["box_mask"].cpu()) for o, n in steps]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=SR.N_SCANS)
    ap.add_argument("--out", help="write the readings to this JSON file")
    args = ap.parse_args(argv)
    cfg = Config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype="float32"))
    runs = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="repeat_check_", dir=runs)
    try:
        root = os.path.join(work, "kitti")
        SR.write_sequences(root, cfg, args.scans)
        ckpt = os.path.join(work, "ckpt")
        save_checkpoint_from_trees(ckpt, cfg, *init_params(
            cfg, np.random.default_rng(0)))
        out = os.path.join(work, "preb_out")
        readings = {}
        for way, (fn, deterministic) in WAYS.items():
            with voxel_sum(fn, deterministic):
                for name, (seq, fixed) in SR.SEQUENCES.items():
                    a, b = (run_once(ckpt, root, out, seq, fixed, args.device)
                            for _ in range(2))
                    diff = [float((x[0] - y[0]).abs().max())
                            for x, y in zip(a, b)]
                    boxes = sum(not (torch.equal(x[1], y[1])
                                     and torch.equal(x[2], y[2]))
                                for x, y in zip(a, b))
                    r = dict(max_abs_per_step=diff, steps_other_boxes=boxes,
                             bit_equal=not boxes and not any(diff))
                    readings[f"{way}, {name}"] = r
                    print(f"{way}, {name}: equal bit for bit "
                          f"{r['bit_equal']}; kept boxes changed on {boxes} "
                          f"of {len(a)} steps; point logits max abs change "
                          f"per step {diff}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(readings, fh, indent=1)
    return readings


if __name__ == "__main__":
    main()
