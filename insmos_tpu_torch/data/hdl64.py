"""HDL-64E raycast scan generator (the port's own numpy copy of
``insmos_tpu/data/hdl64.py``: ``_make_world``, ``raycast_scan`` and
``make_hdl64_window``).

The synthetic fixture the streaming runs use: 64 beams at elevations
+2.0 .. -24.9 deg, 2048 azimuth steps per revolution, the sensor 1.73 m
above the ground, a static world of walls and pillars plus car-sized
moving boxes; rays return the nearest surface. Given the same generator
state, both copies draw the same numbers in the same order, so their scans
are bit-identical (``tests/test_torch_config.py``). ``make_stream`` and
``make_fixed_frame_stream`` turn them into the two streams of the JAX
package's bench: ref-exact, and fixed-frame incremental (its headline).
"""

from __future__ import annotations

import numpy as np

N_BEAMS = 64
N_AZIMUTH = 2048
SENSOR_HEIGHT = 1.73  # m above ground (KITTI mounting)
ELEV_HI = np.deg2rad(2.0)
ELEV_LO = np.deg2rad(-24.9)
MAX_RANGE = 80.0


def _make_world(rng: np.random.Generator, n_walls=18, n_pillars=110, n_cars=5):
    """Static world in a fixed odometry frame, ground z = 0.

    walls: (M, 5) [x0, y0, x1, y1, height] vertical rectangles.
    pillars: (K, 4) [cx, cy, radius, height] vertical cylinders.
    cars: (J, 7) [cx, cy, vx, vy, half_l, half_w, height] moving boxes,
          raycast as cylinders; vx, vy in m per scan step.
    """
    walls = []
    for _ in range(n_walls):
        # building facades roughly parallel to the road (x axis)
        side = rng.choice([-1.0, 1.0])
        y0 = side * rng.uniform(8.0, 42.0)
        x0 = rng.uniform(-70.0, 40.0)
        length = rng.uniform(8.0, 35.0)
        ang = rng.normal(0.0, 0.12)
        x1 = x0 + length * np.cos(ang)
        y1 = y0 + length * np.sin(ang)
        h = rng.uniform(3.0, 12.0)
        walls.append([x0, y0, x1, y1, h])
    pillars = np.stack(
        [
            rng.uniform(-70, 70, n_pillars),
            rng.uniform(-45, 45, n_pillars),
            rng.uniform(0.08, 0.9, n_pillars),
            rng.uniform(0.8, 7.0, n_pillars),
        ],
        axis=-1,
    )
    # traffic on lanes parallel to the road, mostly 10-60 m out
    cars = np.stack(
        [
            rng.uniform(-55, 65, n_cars),
            rng.choice([-1.0, 1.0], n_cars) * rng.uniform(2.5, 9.0, n_cars),
            rng.choice([-1.0, 1.0], n_cars) * rng.uniform(0.8, 1.8, n_cars),
            rng.uniform(-0.1, 0.1, n_cars),
            np.full(n_cars, 2.2),
            np.full(n_cars, 0.9),
            np.full(n_cars, 1.6),
        ],
        axis=-1,
    )
    return np.asarray(walls, np.float64), pillars, cars


def raycast_scan(
    world, ego_xy: np.ndarray, t_step: int, rng: np.random.Generator
):
    """One revolution from sensor at (ego_xy, ground + SENSOR_HEIGHT).

    Returns (points (N, 4) float32 in the SENSOR frame (world-aligned
    orientation), moving_mask (N,) bool). N varies (dropped no-returns).
    """
    walls, pillars, cars = world
    az = (np.arange(N_AZIMUTH) + 0.5) / N_AZIMUTH * 2 * np.pi - np.pi
    el = np.linspace(ELEV_HI, ELEV_LO, N_BEAMS)
    cos_az, sin_az = np.cos(az), np.sin(az)  # (A,)

    # --- 2D horizontal range to each obstacle per azimuth ray ----------
    o = np.asarray(ego_xy, np.float64)
    d = np.stack([cos_az, sin_az], -1)  # (A, 2)

    r2d = np.full((N_AZIMUTH,), np.inf)
    kind = np.zeros((N_AZIMUTH,), np.int8)  # 0 none, 1 wall, 2 pillar, 3 car
    htop = np.zeros((N_AZIMUTH,))  # obstacle top height at the hit

    # walls: segment intersection o + r d = p0 + s (p1 - p0), s in [0, 1]
    p0 = walls[:, 0:2] - o[None]
    e = walls[:, 2:4] - walls[:, 0:2]  # (M, 2)
    denom = d[:, None, 0] * (-e[None, :, 1]) - d[:, None, 1] * (-e[None, :, 0])
    denom = np.where(np.abs(denom) < 1e-9, np.nan, denom)
    rr = (p0[None, :, 0] * (-e[None, :, 1]) - p0[None, :, 1] * (-e[None, :, 0])) / denom
    ss = (d[:, None, 0] * p0[None, :, 1] - d[:, None, 1] * p0[None, :, 0]) / denom
    ok = (rr > 0.5) & (ss >= 0) & (ss <= 1) & np.isfinite(rr)
    rr = np.where(ok, rr, np.inf)
    iw = np.argmin(rr, axis=1)
    rw = rr[np.arange(N_AZIMUTH), iw]
    hit = rw < r2d
    r2d = np.where(hit, rw, r2d)
    kind = np.where(hit, 1, kind)
    htop = np.where(hit, walls[iw, 4], htop)

    # pillars + cars as circles: |o + r d - c| = R
    circles = [
        (pillars[:, 0:2], pillars[:, 2], pillars[:, 3], 2),
        (
            cars[:, 0:2] + t_step * cars[:, 2:4],
            np.hypot(cars[:, 4], cars[:, 5]) * 0.8,
            cars[:, 6],
            3,
        ),
    ]
    for cxy, rad, hgt, kd in circles:
        pc = cxy - o[None]  # (K, 2)
        b = d @ pc.T  # (A, K) projection
        c2 = (pc * pc).sum(-1)[None] - rad[None] ** 2
        disc = b * b - c2
        rr = b - np.sqrt(np.maximum(disc, 0.0))
        ok = (disc > 0) & (rr > 0.5)
        rr = np.where(ok, rr, np.inf)
        ik = np.argmin(rr, axis=1)
        rk = rr[np.arange(N_AZIMUTH), ik]
        hit = rk < r2d
        r2d = np.where(hit, rk, r2d)
        kind = np.where(hit, kd, kind)
        htop = np.where(hit, hgt[ik], htop)

    # --- per-beam ranges -------------------------------------------------
    tan_el = np.tan(el)[:, None]  # (B, 1)
    cos_el = np.cos(el)[:, None]
    # horizontal range at which the beam reaches the obstacle's top
    r_obst = r2d[None, :] / np.maximum(cos_el, 1e-6)  # slant range
    z_at_obst = SENSOR_HEIGHT + r2d[None, :] * tan_el
    hits_obst = (
        np.isfinite(r2d)[None, :]
        & (z_at_obst >= 0.0)
        & (z_at_obst <= htop[None, :])
    )
    # ground return where the beam passes over/misses the obstacle
    r_ground_h = np.where(
        tan_el < -1e-4, -SENSOR_HEIGHT / tan_el, np.inf
    )  # horizontal range
    r_ground = r_ground_h / np.maximum(cos_el, 1e-6)
    ground_blocked = np.isfinite(r2d)[None, :] & (r_ground_h > r2d[None, :])
    hits_ground = np.isfinite(r_ground) & ~ground_blocked & ~hits_obst

    slant = np.where(hits_obst, r_obst, np.where(hits_ground, r_ground, np.inf))
    valid = np.isfinite(slant) & (slant < MAX_RANGE / np.maximum(cos_el, 1e-6))

    # --- to cartesian ----------------------------------------------------
    b_i, a_i = np.nonzero(valid)
    is_obst = hits_obst[b_i, a_i]
    # rough surfaces scatter more than the 1.5 cm sensor noise floor
    sigma = np.where(is_obst, 0.06, 0.02)
    r = slant[valid] + rng.normal(0, 1.0, b_i.shape[0]) * sigma
    ce, se = np.cos(el[b_i]), np.sin(el[b_i])
    x = r * ce * cos_az[a_i]
    y = r * ce * sin_az[a_i]
    z = r * se  # sensor frame: ground returns land near z = -1.73
    # gentle terrain undulation (smooth +-25 cm), ground returns only
    gx, gy = x + ego_xy[0], y + ego_xy[1]
    terrain = 0.14 * np.sin(0.041 * gx + 1.1) + 0.11 * np.sin(
        0.033 * gy - 0.6
    ) + 0.06 * np.sin(0.021 * (gx + gy))
    z = np.where(is_obst, z, z + terrain)
    pts = np.stack([x, y, z, rng.uniform(0, 1, len(x))], -1).astype(np.float32)
    moving = (kind[a_i] == 3) & hits_obst[b_i, a_i]
    return pts, moving


def make_hdl64_window(cfg, seed: int = 0, n_scans: int | None = None):
    """A pose-aligned window of raycast HDL-64E scans, aligned to the last
    scan's frame (the ego translates without turning, so aligned means
    translated), with the raycast's moving labels (2 moving, 1 static).
    Returns the sample dict of the JAX package's make_hdl64_window (no
    boxes), bit for bit."""
    rng = np.random.default_rng(seed)
    W = n_scans or cfg.model.n_past_steps
    P = cfg.runtime.max_points_per_scan
    world = _make_world(rng)
    ego_speed = np.array([1.1, 0.05])  # m per scan step (~11 m/s at 10 Hz)

    pts = np.zeros((W, P, 4), np.float32)
    num = np.zeros((W,), np.int32)
    labels = np.zeros((W, P), np.int32)
    ego_cur = ego_speed * (W - 1)
    for w in range(W):
        ego = ego_speed * w
        scan, moving = raycast_scan(world, ego, w, rng)
        scan = scan.copy()
        scan[:, :2] += (ego - ego_cur)[None].astype(np.float32)
        n = min(len(scan), P)
        sel = rng.permutation(len(scan))[:n]
        pts[w, :n] = scan[sel]
        labels[w, :n] = np.where(moving[sel], 2, 1)
        num[w] = n
    return {
        "points": pts,
        "num_points": num,
        "scan_mask": np.ones((W,), bool),
        "labels": labels,
        "gt_boxes": np.zeros((cfg.model.head.max_objs, 8), np.float32),
        "num_boxes": np.int32(0),
    }


def _raycast_steps(n_steps: int, seed: int):
    """The streams' common generator: yields (step, ego xy, raw scan, rng)
    for a moving ego (~11 m/s at 10 Hz) raycasting the fixture world. The
    caller draws its permutation from ``rng`` before asking for the next
    scan, so the draws come in the reference's order (raycast, then
    permutation, per step)."""
    rng = np.random.default_rng(seed)
    world = _make_world(rng)
    ego_speed = np.array([1.1, 0.05])
    for w in range(n_steps):
        ego = ego_speed * w
        scan, _ = raycast_scan(world, ego, w, rng)
        yield w, ego, scan, rng


def make_pose_stream(cfg, n_steps: int, seed: int = 0, turn: bool = True):
    """The fixture streams as a sensor would record them: each scan in its
    sensor frame, randomly permuted and cut to
    ``cfg.runtime.max_points_per_scan``, beside the LiDAR pose of each step
    (float64, the first the identity). The ego moves ~11 m/s and, with
    ``turn``, turns at 0.01 rad/step (:func:`make_stream`'s stream);
    without, its scans are those that :func:`make_fixed_frame_stream`
    frames. Returns (scans [(n_i, 4) float32], poses (n_steps, 4, 4))."""
    P = cfg.runtime.max_points_per_scan
    scans, poses = [], []
    for w, ego, scan, rng in _raycast_steps(n_steps, seed):
        pose = np.eye(4)
        pose[:2, 3] = ego
        scan_f = scan.astype(np.float32).copy()
        if turn:
            psi = 0.01 * w
            c, s = np.cos(psi), np.sin(psi)
            pose[:2, :2] = [[c, -s], [s, c]]
            scan_f[:, :2] = scan_f[:, :2] @ np.float32([[c, s], [-s, c]]).T
        n = min(len(scan_f), P)
        scans.append(scan_f[rng.permutation(len(scan_f))[:n]])
        poses.append(pose)
    return scans, np.stack(poses)


def make_stream(cfg, n_steps: int, seed: int = 0):
    """The ref-exact stream of the JAX package's bench.make_stream: a
    moving ego (~11 m/s) turning at 0.01 rad/step raycasts the fixture
    world; each scan is in its sensor frame, randomly permuted and cut to
    ``cfg.runtime.max_points_per_scan``, and each step's transform
    inv(pose_t) @ pose_{t-1} carries the real rotation. Returns (scans
    [(n_i, 4) float32], tfs [(4, 4) float32])."""
    scans, poses = make_pose_stream(cfg, n_steps, seed)
    tfs = [(np.linalg.inv(p) @ poses[max(i - 1, 0)]).astype(np.float32)
           for i, p in enumerate(poses)]
    return scans, tfs


def make_fixed_frame_stream(cfg, n_steps: int, seed: int = 0):
    """The fixed-frame stream of the JAX package's bench.make_stream (its
    headline, ``ref_exact=False``): the same ego without turning, each scan
    permuted and cut as in :func:`make_stream`, then re-expressed by
    ``pipeline.fixed_frame_transform`` in the voxel-snapped odometry frame.
    Each step's transform is the snapped integer-voxel translation k *
    voxel. Returns (scans [(n_i, 4) float32], tfs [(4, 4) float32], shifts
    [(3,) int32], the cache shifts -k)."""
    from ..pipeline import fixed_frame_transform

    vox = cfg.data.voxel_size[0]
    scans, tfs, shifts = [], [], []
    prev_snap = None
    for scan, pose in zip(*make_pose_stream(cfg, n_steps, seed, turn=False)):
        scan_f, tf, prev_snap = fixed_frame_transform(scan, pose, prev_snap,
                                                      vox)
        k = np.round(tf[:3, 3] / vox)
        tf_snap = np.eye(4, dtype=np.float32)
        tf_snap[:3, 3] = (k * vox).astype(np.float32)
        scans.append(scan_f)
        tfs.append(tf_snap)
        shifts.append((-k).astype(np.int32))
    return scans, tfs, shifts
