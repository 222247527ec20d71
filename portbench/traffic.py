"""The benchmark's traffic: HDL-64E raycast drives through a tiled world.

One general generator serves every mix. A mix file (``mixes/<mix>.json``)
gives its parameters: how many streams step together, the sensor, the
world's tiles, the drive's speed and heading, and how far ahead of the
stepping process the scans are made. The raycast is the repository
fixture's (the nearest surface returned along each beam), copied here so
that a change to the program cannot change the traffic; the sensor
(``sensor`` in the mix: beams, their elevations, azimuth steps, height and
range) is the mix's, the fixture's HDL-64E in ``drive`` and ``pod8``. A
mix that needs its own streams names them in ``mixes/<mix>.py``
(``make_stream``, see :func:`make_stream`).

The fixture's world ends at x = +-70 m, which a drive at 1.1 m a scan
leaves after ~60 scans. Here the world is laid out in tiles of
``tile_m`` along the road, each drawn from the stream's seed as the
fixture draws its one world (walls, pillars, moving cars), so a drive of
any length sees the fixture's density of surfaces. A car's track is
anchored at the step when the ego passes its tile's centre, so every
tile looks to the ego as the fixture's world looks at its start.

The heading turns by at most ``turn_max_rad`` a scan and stays inside
``heading_band_rad``: it follows a slow weave and steers back to the lane,
so every ref-exact step carries a real rotation. Every draw comes from a
``numpy.random.Generator`` keyed by (seed, purpose, index), so a step's
scan does not depend on which steps were made before it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import threading

import numpy as np

_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


# --------------------------------------------------------------- the world
def make_tile(rng: np.random.Generator, n_walls: int, n_pillars: int,
              n_cars: int):
    """One tile, centred on x = 0, drawn as the fixture draws its world:
    walls (M, 5) [x0, y0, x1, y1, h], pillars (K, 4) [cx, cy, r, h], cars
    (J, 7) [cx, cy, vx, vy, half_l, half_w, h] with v in m a scan."""
    walls = []
    for _ in range(n_walls):
        side = rng.choice([-1.0, 1.0])
        y0 = side * rng.uniform(8.0, 42.0)
        x0 = rng.uniform(-70.0, 40.0)
        length = rng.uniform(8.0, 35.0)
        ang = rng.normal(0.0, 0.12)
        walls.append([x0, y0, x0 + length * np.cos(ang),
                      y0 + length * np.sin(ang), rng.uniform(3.0, 12.0)])
    pillars = np.stack([rng.uniform(-70, 70, n_pillars),
                        rng.uniform(-45, 45, n_pillars),
                        rng.uniform(0.08, 0.9, n_pillars),
                        rng.uniform(0.8, 7.0, n_pillars)], axis=-1)
    cars = np.stack([rng.uniform(-55, 65, n_cars),
                     rng.choice([-1.0, 1.0], n_cars)
                     * rng.uniform(2.5, 9.0, n_cars),
                     rng.choice([-1.0, 1.0], n_cars)
                     * rng.uniform(0.8, 1.8, n_cars),
                     rng.uniform(-0.1, 0.1, n_cars),
                     np.full(n_cars, 2.2), np.full(n_cars, 0.9),
                     np.full(n_cars, 1.6)], axis=-1)
    return np.asarray(walls, np.float64), pillars, cars


class TiledWorld:
    """Tiles along x, drawn lazily from (seed, 1, tile index)."""

    def __init__(self, seed: int, world: dict, max_range_m: float):
        self.seed = int(seed)
        self.w = world
        self.max_range = max_range_m
        self._tiles = {}

    def tile(self, k: int):
        if k not in self._tiles:
            rng = np.random.default_rng([self.seed, 1, k + 2**20])
            self._tiles[k] = make_tile(rng, self.w["walls_per_tile"],
                                       self.w["pillars_per_tile"],
                                       self.w["cars_per_tile"])
        return self._tiles[k]

    def around(self, ego_xy, step: int):
        """(walls, pillars, cars at this step with v = 0) near the ego:
        the static tiles within one pitch, and every car within
        ``car_reach_m`` of the ego at this step."""
        L = self.w["tile_m"]
        k0 = int(np.floor(ego_xy[0] / L + 0.5))
        walls, pillars, cars = [], [], []
        for k in range(k0 - 1, k0 + 2):
            tw, tp, _ = self.tile(k)
            off = np.array([k * L, 0.0, k * L, 0.0, 0.0])
            walls.append(tw + off)
            pillars.append(tp + np.array([k * L, 0.0, 0.0, 0.0]))
        reach = self.w["car_reach_m"]
        span = int(np.ceil(reach * 3 / L)) + 1
        for k in range(k0 - span, k0 + span + 1):
            tc = self.tile(k)[2].copy()
            t_rel = step - k * L / self.w["speed_m"]
            tc[:, 0] += k * L + t_rel * tc[:, 2]
            tc[:, 1] += t_rel * tc[:, 3]
            near = np.hypot(tc[:, 0] - ego_xy[0], tc[:, 1] - ego_xy[1]) < reach
            cars.append(tc[near])
        cars = np.concatenate(cars)
        cars[:, 2:4] = 0.0
        # a pillar whose nearest surface lies beyond the sensor's range
        # returns nothing and blocks nothing that returns
        pillars = np.concatenate(pillars)
        dist = np.hypot(pillars[:, 0] - ego_xy[0], pillars[:, 1] - ego_xy[1])
        pillars = pillars[dist - pillars[:, 2] < self.max_range + 0.5]
        return np.concatenate(walls), pillars, cars


def raycast_scan(world, ego_xy, rng: np.random.Generator, sensor: dict):
    """One revolution from the sensor at (ego_xy, ``height_m``): points
    (N, 4) float32, sensor-centred with the world's orientation. The
    fixture's raycast; cars are placed by the caller. ``sensor``: beams
    evenly spaced from ``elev_hi_deg`` down to ``elev_lo_deg``,
    ``azimuth_steps`` a revolution, returns within ``max_range_m`` (along
    the ground)."""
    walls, pillars, cars = world
    n_az = sensor["azimuth_steps"]
    height, max_range = sensor["height_m"], sensor["max_range_m"]
    az = (np.arange(n_az) + 0.5) / n_az * 2 * np.pi - np.pi
    el = np.linspace(np.deg2rad(sensor["elev_hi_deg"]),
                     np.deg2rad(sensor["elev_lo_deg"]), sensor["beams"])
    cos_az, sin_az = np.cos(az), np.sin(az)
    o = np.asarray(ego_xy, np.float64)
    d = np.stack([cos_az, sin_az], -1)
    r2d = np.full((n_az,), np.inf)
    kind = np.zeros((n_az,), np.int8)
    htop = np.zeros((n_az,))

    p0 = walls[:, 0:2] - o[None]
    e = walls[:, 2:4] - walls[:, 0:2]
    denom = d[:, None, 0] * (-e[None, :, 1]) - d[:, None, 1] * (-e[None, :, 0])
    denom = np.where(np.abs(denom) < 1e-9, np.nan, denom)
    rr = (p0[None, :, 0] * (-e[None, :, 1])
          - p0[None, :, 1] * (-e[None, :, 0])) / denom
    ss = (d[:, None, 0] * p0[None, :, 1] - d[:, None, 1] * p0[None, :, 0]) / denom
    ok = (rr > 0.5) & (ss >= 0) & (ss <= 1) & np.isfinite(rr)
    rr = np.where(ok, rr, np.inf)
    iw = np.argmin(rr, axis=1)
    rw = rr[np.arange(n_az), iw]
    hit = rw < r2d
    r2d = np.where(hit, rw, r2d)
    kind = np.where(hit, 1, kind)
    htop = np.where(hit, walls[iw, 4], htop)

    circles = [(pillars[:, 0:2], pillars[:, 2], pillars[:, 3], 2),
               (cars[:, 0:2], np.hypot(cars[:, 4], cars[:, 5]) * 0.8,
                cars[:, 6], 3)]
    for cxy, rad, hgt, kd in circles:
        if len(cxy) == 0:
            continue
        pc = cxy - o[None]
        b = d @ pc.T
        c2 = (pc * pc).sum(-1)[None] - rad[None] ** 2
        disc = b * b - c2
        rr = b - np.sqrt(np.maximum(disc, 0.0))
        ok = (disc > 0) & (rr > 0.5)
        rr = np.where(ok, rr, np.inf)
        ik = np.argmin(rr, axis=1)
        rk = rr[np.arange(n_az), ik]
        hit = rk < r2d
        r2d = np.where(hit, rk, r2d)
        kind = np.where(hit, kd, kind)
        htop = np.where(hit, hgt[ik], htop)

    tan_el = np.tan(el)[:, None]
    cos_el = np.cos(el)[:, None]
    r_obst = r2d[None, :] / np.maximum(cos_el, 1e-6)
    z_at_obst = height + r2d[None, :] * tan_el
    hits_obst = (np.isfinite(r2d)[None, :] & (z_at_obst >= 0.0)
                 & (z_at_obst <= htop[None, :]))
    r_ground_h = np.where(tan_el < -1e-4, -height / tan_el, np.inf)
    r_ground = r_ground_h / np.maximum(cos_el, 1e-6)
    ground_blocked = np.isfinite(r2d)[None, :] & (r_ground_h > r2d[None, :])
    hits_ground = np.isfinite(r_ground) & ~ground_blocked & ~hits_obst
    slant = np.where(hits_obst, r_obst, np.where(hits_ground, r_ground, np.inf))
    valid = np.isfinite(slant) & (slant < max_range / np.maximum(cos_el, 1e-6))

    b_i, a_i = np.nonzero(valid)
    is_obst = hits_obst[b_i, a_i]
    sigma = np.where(is_obst, 0.06, 0.02)
    r = slant[valid] + rng.normal(0, 1.0, b_i.shape[0]) * sigma
    ce, se = np.cos(el[b_i]), np.sin(el[b_i])
    x = r * ce * cos_az[a_i]
    y = r * ce * sin_az[a_i]
    z = r * se
    gx, gy = x + ego_xy[0], y + ego_xy[1]
    terrain = (0.14 * np.sin(0.041 * gx + 1.1) + 0.11 * np.sin(0.033 * gy - 0.6)
               + 0.06 * np.sin(0.021 * (gx + gy)))
    z = np.where(is_obst, z, z + terrain)
    return np.stack([x, y, z, rng.uniform(0, 1, len(x))], -1).astype(np.float32)


# --------------------------------------------------------------- the drive
def drive_poses(seed: int, n_steps: int, world: dict) -> np.ndarray:
    """(n_steps, 4, 4) float64 LiDAR poses: ``speed_m`` a scan along the
    heading; the heading moves towards a weave of amplitude
    ``weave_amp_rad`` and period ``weave_period`` minus a pull back to the
    lane (``keep_lane_gain`` rad a metre), by at most ``turn_max_rad`` a
    scan, inside +-``heading_band_rad``."""
    rng = np.random.default_rng([int(seed), 2])
    phase = rng.uniform(0, 2 * np.pi)
    band, turn = world["heading_band_rad"], world["turn_max_rad"]
    xy, psi = np.zeros(2), 0.0
    poses = np.zeros((n_steps, 4, 4))
    for w in range(n_steps):
        c, s = np.cos(psi), np.sin(psi)
        poses[w] = np.eye(4)
        poses[w, :2, :2] = [[c, -s], [s, c]]
        poses[w, :2, 3] = xy
        target = (world["weave_amp_rad"]
                  * np.sin(2 * np.pi * w / world["weave_period"] + phase)
                  - world["keep_lane_gain"] * xy[1])
        target = float(np.clip(target, -band, band))
        psi = float(np.clip(psi + np.clip(target - psi, -turn, turn),
                            -band, band))
        xy = xy + world["speed_m"] * np.array([np.cos(psi), np.sin(psi)])
    return poses


def fixed_frame_transform(scan: np.ndarray, pose: np.ndarray,
                          prev_snap, voxel: float):
    """The fixed-frame mode's framing: the scan in the world's orientation
    about an origin snapped to the voxel grid; the step's transform is the
    integer-voxel translation prev_snap - snap. Returns (scan, tf, snap)."""
    R, t = pose[:3, :3], pose[:3, 3]
    snap = (np.round(t / voxel) * voxel).astype(np.float32)
    out = scan.astype(np.float32).copy()
    out[:, :3] = scan[:, :3] @ R.T.astype(np.float32) + (
        t.astype(np.float32) - snap)
    tf = np.eye(4, dtype=np.float32)
    if prev_snap is not None:
        tf[:3, 3] = prev_snap - snap
    return out, tf, snap


class Stream:
    """One vehicle's scans as a pipeline step takes them: (scan (n, 4)
    float32, tf (4, 4) float32) for step 0, 1, ... ``fixed_frame`` frames
    each scan by :func:`fixed_frame_transform`; otherwise the scan is in
    its sensor frame and tf = inv(pose_t) @ pose_{t-1}."""

    def __init__(self, seed: int, mix: dict, max_points: int,
                 fixed_frame: bool, voxel: float, n_steps: int):
        self.seed = int(seed)
        self.sensor = mix["sensor"]
        self.world = TiledWorld(seed, mix["world"],
                                self.sensor["max_range_m"])
        self.poses = drive_poses(seed, n_steps, mix["world"])
        self.max_points = max_points
        self.fixed_frame = fixed_frame
        self.voxel = voxel
        self._prev_snap = None
        self._step = 0

    def scan(self, w: int) -> np.ndarray:
        """Step w's scan in its sensor frame, permuted and cut to the
        pipeline's capacity as a recorded sequence holds it."""
        pose = self.poses[w]
        ego = pose[:2, 3]
        rng = np.random.default_rng([self.seed, 3, w])
        pts = raycast_scan(self.world.around(ego, w), ego, rng, self.sensor)
        c, s = pose[0, 0], pose[1, 0]
        pts[:, :2] = pts[:, :2] @ np.float32([[c, s], [-s, c]]).T
        n = min(len(pts), self.max_points)
        return pts[rng.permutation(len(pts))[:n]]

    def next(self):
        w = self._step
        self._step += 1
        scan = self.scan(w)
        if self.fixed_frame:
            scan, tf, self._prev_snap = fixed_frame_transform(
                scan, self.poses[w], self._prev_snap, self.voxel)
            return scan, tf
        prev = self.poses[max(w - 1, 0)]
        return scan, (np.linalg.inv(self.poses[w]) @ prev).astype(np.float32)


def stream_seeds(seed: int, mix: dict) -> list[int]:
    """The seeds of a mix's streams: slot i drives the world of
    ``slot_seed_stride * seed + i``; a single stream drives ``seed``."""
    n = mix["streams"]
    if n == 1:
        return [int(seed)]
    return [mix["slot_seed_stride"] * int(seed) + i for i in range(n)]


def load_hooks(path):
    """The module of a mix's ``mixes/<mix>.py``, or None."""
    if not path:
        return None
    import importlib.util

    name = "portbench_mix_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_stream(seed: int, mix: dict, max_points: int, fixed_frame: bool,
                voxel: float, n_steps: int):
    """A stream's generator: the mix's own ``make_stream`` (same
    arguments) where its ``mixes/<mix>.py`` has one, else :class:`Stream`.
    Either gives ``next() -> (scan, tf)``, step after step."""
    hooks = load_hooks(mix.get("hooks_file"))
    make = getattr(hooks, "make_stream", None) or Stream
    return make(seed, mix, max_points, fixed_frame, voxel, n_steps)


def _produce(seeds, mix, max_points, fixed_frame, voxel, n_steps, out_q,
             room, stop, cpu):
    """The child process: makes every stream's next step, in step order,
    while ``room`` (a semaphore the consumer releases a step at a time)
    allows, and puts [(scan, tf), ...] on ``out_q``. With ``cpu``, it
    runs on that core alone, at a lower priority than the stepping
    process."""
    if cpu is not None:
        os.sched_setaffinity(0, {cpu})
        os.nice(5)
    streams = [make_stream(s, mix, max_points, fixed_frame, voxel, n_steps)
               for s in seeds]
    for _ in range(n_steps):
        while not room.acquire(timeout=0.2):
            if stop.is_set():
                return
        if stop.is_set():
            return
        out_q.put([st.next() for st in streams])


class Producer:
    """Scans made ahead of time in a child process (spawned, one thread,
    on core ``cpu`` alone where given), handed over through a queue. A
    thread of the stepping process receives them as they come, so that
    :meth:`get` waits only where the generator is behind. At most
    ``ahead`` steps wait at a time."""

    def __init__(self, seeds, mix, max_points, fixed_frame, voxel,
                 n_steps, ahead, cpu=None):
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.room = ctx.Semaphore(ahead)
        self.stop_ev = ctx.Event()
        self.proc = ctx.Process(
            target=_produce, daemon=True,
            args=(list(seeds), mix, max_points, fixed_frame, voxel,
                  n_steps, self.q, self.room, self.stop_ev, cpu))
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            self.proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._got = queue_mod.Queue()
        self._rx_stop = threading.Event()
        self._rx = threading.Thread(target=self._receive, daemon=True)
        self._rx.start()

    def _receive(self):
        while not self._rx_stop.is_set():
            try:
                self._got.put(self.q.get(timeout=0.2))
            except queue_mod.Empty:
                pass

    def get(self, timeout: float = 120.0):
        """The next step's [(scan, tf), ...], one entry a stream."""
        item = self._got.get(timeout=timeout)
        self.room.release()
        return item

    def close(self):
        """Stops the child and the receiving thread and waits for both,
        draining the queue first."""
        self.stop_ev.set()
        self._rx_stop.set()
        self._rx.join(timeout=10)
        for _ in range(1000):
            try:
                self.q.get_nowait()
            except queue_mod.Empty:
                if not self.proc.is_alive():
                    break
                self.proc.join(timeout=0.05)
        self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
        self.q.close()
        self.q.join_thread()

