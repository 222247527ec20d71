"""Synthetic KITTI-format mini sequences (the port's own copy of
``insmos_tpu/data/synthetic.py``: the same seed writes the same bytes,
which tests/test_torch_cli.py checks).

Writes a directory tree byte-compatible with SemanticKITTI-MOS
(velodyne/*.bin, labels/*.label, boundingbox_label/*.npy, poses.txt,
calib.txt) so IO, inference, refine, and evaluation paths can be exercised
end-to-end without the real dataset. The scene: a ground plane + static
pillars + a few moving boxes translating at constant velocity; the ego
vehicle drives forward, so pose alignment is non-trivial.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import LEARNING_MAP_INV


def _make_scene(
    rng: np.random.Generator,
    n_static: int = 12,
    n_moving: int = 3,
    area: tuple[float, float] = (40.0, 30.0),
    mover_area: tuple[float, float] = (25.0, 15.0),
    mover_speed: float = 2.0,
    mover_dims: tuple[float, float, float] = (4.2, 1.8, 1.6),
):
    """``area``/``mover_area`` shrink the scene to fit small crop ranges
    (closed-loop tests use tiny configs); defaults match the original
    road-scale scene."""
    ax, ay = area
    mx, my = mover_area
    pillars = rng.uniform([-ax, -ay, -1.5], [ax, ay, -1.4], size=(n_static, 3))
    movers = []
    for _ in range(n_moving):
        pos = rng.uniform([-mx, -my, -1.0], [mx, my, -1.0])
        vel = rng.uniform(
            [-mover_speed, -mover_speed / 4, 0], [mover_speed, mover_speed / 4, 0]
        )
        yaw = float(np.arctan2(vel[1], vel[0]))
        dims = np.array(mover_dims)
        movers.append((pos, vel, yaw, dims))
    return pillars, movers


def _render_scan(
    rng: np.random.Generator,
    ego_xy: np.ndarray,
    pillars: np.ndarray,
    movers,
    t: float,
    n_ground: int = 4000,
    n_per_obj: int = 220,
    ground_extent: tuple[float, float] = (45.0, 35.0),
):
    """Points in the WORLD frame + per-point learning labels {1,2}."""
    pts, labels = [], []
    gx, gy = ground_extent
    g = rng.uniform([-gx, -gy, -1.73], [gx, gy, -1.68], size=(n_ground, 3))
    g[:, :2] += ego_xy
    pts.append(g)
    labels.append(np.ones(len(g), dtype=np.int32))
    for c in pillars:
        p = c + rng.normal(scale=[0.3, 0.3, 0.6], size=(n_per_obj, 3))
        p[:, 2] = np.abs(p[:, 2]) + c[2]
        pts.append(p)
        labels.append(np.ones(len(p), dtype=np.int32))
    for pos, vel, yaw, dims in movers:
        center = pos + vel * t
        local = rng.uniform(-dims / 2, dims / 2, size=(n_per_obj, 3))
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        p = local @ rot.T + center
        pts.append(p)
        labels.append(np.full(len(p), 2, dtype=np.int32))
    return np.concatenate(pts), np.concatenate(labels)


def write_synthetic_sequence(
    root: str,
    seq: int = 8,
    n_scans: int = 14,
    seed: int = 0,
    dt: float = 0.1,
    ego_speed: float = 2.0,
    n_ground: int = 4000,
    n_per_obj: int = 220,
    n_static: int = 12,
    n_moving: int = 3,
    area: tuple[float, float] = (40.0, 30.0),
    mover_area: tuple[float, float] = (25.0, 15.0),
    mover_speed: float = 2.0,
    mover_dims: tuple[float, float, float] = (4.2, 1.8, 1.6),
    ground_extent: tuple[float, float] = (45.0, 35.0),
) -> str:
    """Create `<root>/<seq:02d>/...`; returns the sequence directory."""
    rng = np.random.default_rng(seed)
    seq_dir = os.path.join(root, f"{seq:02d}")
    for sub in ("velodyne", "labels", "boundingbox_label"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)

    pillars, movers = _make_scene(
        rng, n_static=n_static, n_moving=n_moving, area=area,
        mover_area=mover_area, mover_speed=mover_speed, mover_dims=mover_dims,
    )

    # calib: simple axis permutation LiDAR->cam (x,y,z)->(-y,-z,x)
    t_cam_velo = np.array(
        [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0.27], [0, 0, 0, 1.0]]
    )
    with open(os.path.join(seq_dir, "calib.txt"), "w") as fh:
        fh.write("Tr: " + " ".join(f"{v:.12e}" for v in t_cam_velo[:3].reshape(-1)))
        fh.write("\n")

    pose_rows = []
    for i in range(n_scans):
        t = i * dt
        ego_xy = np.array([ego_speed * t, 0.0])
        world_pts, labels = _render_scan(
            rng, ego_xy, pillars, movers, t, n_ground=n_ground,
            n_per_obj=n_per_obj, ground_extent=ground_extent,
        )
        # LiDAR frame = world shifted by ego position
        lidar_pts = world_pts.copy()
        lidar_pts[:, 0] -= ego_xy[0]
        lidar_pts[:, 1] -= ego_xy[1]
        intensity = rng.uniform(0, 1, size=(len(lidar_pts), 1)).astype(np.float32)
        scan = np.hstack([lidar_pts.astype(np.float32), intensity])
        scan.astype(np.float32).tofile(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin")
        )

        raw = LEARNING_MAP_INV[labels].astype(np.uint32)
        raw.tofile(os.path.join(seq_dir, "labels", f"{i:06d}.label"))

        # boundingbox_label rows: [inst_id, raw_class, dynamic, [x,y,z,l,w,h,yaw]]
        box_rows = []
        for k, (pos, vel, yaw, dims) in enumerate(movers):
            center = pos + vel * t
            center_lidar = center.copy()
            center_lidar[0] -= ego_xy[0]
            center_lidar[1] -= ego_xy[1]
            box_rows.append(
                [
                    k,
                    1,  # raw class: car
                    1,  # dynamic
                    [
                        float(center_lidar[0]),
                        float(center_lidar[1]),
                        float(center_lidar[2]),
                        float(dims[0]),
                        float(dims[1]),
                        float(dims[2]),
                        float(yaw),
                    ],
                ]
            )
        np.save(
            os.path.join(seq_dir, "boundingbox_label", f"{i:06d}.npy"),
            np.array(box_rows, dtype=object),
            allow_pickle=True,
        )

        # camera-frame pose: P_i = T_cam_velo @ T_w_lidar_i @ T_velo_cam,
        # then poses.txt stores P_i directly (world cam frame, first = identity-ish)
        t_w_lidar = np.eye(4)
        t_w_lidar[0, 3] = ego_xy[0]
        t_w_lidar[1, 3] = ego_xy[1]
        pose_cam = t_cam_velo @ t_w_lidar @ np.linalg.inv(t_cam_velo)
        pose_rows.append(" ".join(f"{v:.12e}" for v in pose_cam[:3].reshape(-1)))

    with open(os.path.join(seq_dir, "poses.txt"), "w") as fh:
        fh.write("\n".join(pose_rows) + "\n")
    return seq_dir
