"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Everything is made from a seed with numpy and handed to both the JAX
package and the port."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from insmos_tpu.config import Config, DataConfig, MotionNetConfig


def cpu_threads() -> int:
    """Intra-op threads for one test process: the machine's cores shared
    among the pytest-xdist workers that run beside it. torch's OpenMP pool
    sizes itself to the whole machine in every worker, and its threads
    spin between the many small ops of a pipeline step; with 6 workers on
    8 cores that made the port's pipeline steps run tens of times slower
    than in one process."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


torch.set_num_threads(cpu_threads())


def tiny_config(window: int = 4, points: int = 2048,
                engine: str = "auto") -> Config:
    """The JAX package's tests' tiny config (tests/test_model.py), float32."""
    base = Config()
    return dataclasses.replace(
        base,
        data=DataConfig(point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)),
        model=dataclasses.replace(
            base.model,
            n_past_steps=window,
            max_voxels=4096,
            unet_capacities=(4096, 2048, 1024, 512, 512),
            motionnet=MotionNetConfig(
                crop_range=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.8),
                site_capacities=(8192, 4096, 2048, 1024),
            ),
        ),
        runtime=dataclasses.replace(
            base.runtime, max_points_per_scan=points,
            compute_dtype="float32", sparse_engine=engine,
        ),
    )


def hdl64_crop_stream(n_scans: int, seed: int = 0, half: float = 6.6,
                      max_points: int = 2048, yaw_rate: float = 0.01):
    """A small crop of the HDL-64E raycast fixture: a moving ego with a
    turning heading, each scan in its sensor frame, cropped to |x|, |y| <
    half and subsampled to max_points. Returns (scans, tfs, poses) with
    tf = inv(pose_t) @ pose_{t-1} (identity first)."""
    from insmos_tpu.data.hdl64 import _make_world, raycast_scan

    rng = np.random.default_rng(seed)
    world = _make_world(rng)
    scans, tfs, poses = [], [], []
    prev = None
    for w in range(n_scans):
        ego = np.array([0.6 * w, 0.05 * w])
        scan, _ = raycast_scan(world, ego, w, rng)
        psi = yaw_rate * w
        c, s = np.cos(psi), np.sin(psi)
        pose = np.eye(4)
        pose[:2, :2] = [[c, -s], [s, c]]
        pose[:2, 3] = ego
        sc = scan.astype(np.float32).copy()
        sc[:, :2] = sc[:, :2] @ np.float32([[c, s], [-s, c]]).T
        keep = (np.abs(sc[:, 0]) < half) & (np.abs(sc[:, 1]) < half)
        sc = sc[keep]
        sc = sc[rng.permutation(len(sc))[:max_points]]
        scans.append(sc)
        tfs.append((np.linalg.inv(pose) @ (prev if prev is not None else pose)
                    ).astype(np.float32))
        prev = pose
        poses.append(pose)
    return scans, tfs, np.stack(poses)


def jax_params_np(cfg, seed: int = 0):
    """The JAX package's own init, as numpy trees."""
    import jax

    from insmos_tpu.nn import InsMOSModel

    params, state = InsMOSModel(cfg).init(jax.random.PRNGKey(seed))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state)


def perturb_bn(state_np, seed: int = 0):
    """BN running stats drawn away from (0, 1), identically for both sides
    (the JAX init leaves them at 0 and 1, which would hide eval-mode BN)."""
    import copy

    rng = np.random.default_rng(seed)
    st = copy.deepcopy(state_np)

    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"mean", "var"}:
                c = t["mean"].shape
                t["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                t["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)

    walk(st)
    return st


def fixed_frame_crop_stream(n_scans: int, seed: int = 0, half: float = 6.6,
                            max_points: int = 2048):
    """A small crop of the HDL-64E raycast fixture for the fixed-frame
    incremental mode: the ego moves as in bench.make_stream (1.1 m and
    0.05 m per step, no turn), each scan is in its sensor frame, cropped to
    |x|, |y| < half and subsampled to max_points. Returns (scans, poses);
    pipeline.fixed_frame_transform turns them into the fixed frame, where
    each step shifts the window by 11 voxels in x (and 0 or 1 in y)."""
    from insmos_tpu.data.hdl64 import _make_world, raycast_scan

    rng = np.random.default_rng(seed)
    world = _make_world(rng)
    scans, poses = [], []
    for w in range(n_scans):
        ego = np.array([1.1, 0.05]) * w
        scan, _ = raycast_scan(world, ego, w, rng)
        keep = (np.abs(scan[:, 0]) < half) & (np.abs(scan[:, 1]) < half)
        sc = scan[keep]
        scans.append(sc[rng.permutation(len(sc))[:max_points]])
        pose = np.eye(4)
        pose[:2, 3] = ego
        poses.append(pose)
    return scans, np.stack(poses)
