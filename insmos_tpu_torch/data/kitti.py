"""KITTI odometry / SemanticKITTI-MOS IO and the sliding-window dataset
(the port's own copy of ``insmos_tpu/data/kitti.py``; tests/test_torch_cli.py
and tests/test_torch_train_data.py hold the two equal).

Host-side numpy, with the reference loaders' semantics: KITTI pose and
calib parsing, the camera-to-LiDAR pose conversion with the first frame as
origin, the label decode, the bounding-box label decode with its class
merge and fake-box rule, window indexing, pose alignment to the current
frame, augmentation and range filtering. Every random draw of a sample
(augmentation, the in-scan shuffle) comes from a generator seeded by
(seed, epoch, index), so a sample is the same whichever loader thread
builds it. :func:`write_sequence`, the readers' inverse for scans and
poses, is the port's own.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import map_semantic_labels, merge_det_class
from .augment import augment_window
from .processor import mask_boxes_outside_range, mask_points_by_range
from .sample import WindowSample, make_window_sample


def load_files(folder: str) -> list[str]:
    """All files under `folder`, sorted."""
    paths = [
        os.path.join(dp, f)
        for dp, _, fn in os.walk(os.path.expanduser(folder))
        for f in fn
    ]
    paths.sort()
    return paths


def load_poses(pose_path: str) -> np.ndarray:
    """(N, 4, 4) camera-frame poses from a KITTI poses.txt (12 or 16 floats/row)."""
    poses = []
    with open(pose_path) as fh:
        for line in fh:
            vals = np.fromstring(line, dtype=np.float64, sep=" ")
            if len(vals) == 12:
                mat = np.vstack([vals.reshape(3, 4), [0, 0, 0, 1]])
            elif len(vals) == 16:
                mat = vals.reshape(4, 4)
            else:
                continue
            poses.append(mat)
    return np.array(poses)


def load_calib(calib_path: str) -> np.ndarray:
    """(4, 4) T_cam_velo from the 'Tr:' line of a KITTI calib.txt."""
    with open(calib_path) as fh:
        for line in fh:
            if "Tr:" in line:
                vals = np.fromstring(line.replace("Tr:", ""),
                                     dtype=np.float64, sep=" ")
                return np.vstack([vals.reshape(3, 4), [0, 0, 0, 1]])
    raise ValueError(f"no 'Tr:' line in {calib_path}")


def lidar_poses_from_files(pose_file: str, calib_file: str) -> np.ndarray:
    """Camera poses -> LiDAR-frame poses, first frame as origin:
    T_i = T_velo_cam @ inv(P_0) @ P_i @ T_cam_velo."""
    poses = load_poses(pose_file)
    inv_frame0 = np.linalg.inv(poses[0])
    t_cam_velo = load_calib(calib_file)
    t_velo_cam = np.linalg.inv(t_cam_velo)
    return np.array([t_velo_cam @ inv_frame0 @ p @ t_cam_velo for p in poses])


def read_point_cloud(filename: str) -> np.ndarray:
    """(N, 4) float32 x,y,z,intensity from a .bin scan."""
    return np.fromfile(filename, dtype=np.float32).reshape(-1, 4)


def read_labels(filename: str) -> np.ndarray:
    """(N,) int32 learning-class labels from a .label file (or empty)."""
    if not os.path.isfile(filename):
        return np.zeros((0,), dtype=np.int32)
    raw = np.fromfile(filename, dtype=np.uint32).reshape(-1)
    return map_semantic_labels(raw).astype(np.int32)


def read_bounding_box_label(filename: str) -> np.ndarray:
    """(M, 9) [merged_class, dynamic, x,y,z,dx,dy,dz,yaw] box labels, with
    the reference's placeholder for an empty file and its fake box when no
    box is dynamic."""
    loaded = np.load(filename, allow_pickle=True)
    if len(loaded) == 0:
        loaded = [[0, 0, 1, [0.0] * 7]]
    rows = []
    any_dynamic = False
    for item in loaded:
        row = np.zeros(9, dtype=np.float64)
        row[0] = merge_det_class(np.array([item[1]]))[0]
        row[1] = item[2]
        row[2:9] = np.asarray(item[3], dtype=np.float64)[:7]
        rows.append(row)
        any_dynamic = any_dynamic or row[1] > 0
    if not any_dynamic:
        rows.append(np.array([0, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.float64))
    return np.array(rows)


def transform_point_cloud(
    xyz: np.ndarray, from_pose: np.ndarray, to_pose: np.ndarray
) -> np.ndarray:
    """Re-express points given in `from_pose`'s frame in `to_pose`'s frame."""
    tf = np.linalg.inv(to_pose) @ from_pose
    return xyz @ tf[:3, :3].T + tf[:3, 3]


def write_sequence(seq_dir: str, scans, poses: np.ndarray) -> str:
    """Write a KITTI-format sequence that the readers above give back
    exactly: ``velodyne/%06d.bin`` (float32 x, y, z, intensity),
    ``poses.txt`` holding the LiDAR poses (N, 4, 4) as camera poses to 17
    significant digits, and a ``calib.txt`` whose ``Tr`` is the identity.
    With ``poses[0]`` the identity, :func:`lidar_poses_from_files` returns
    ``poses`` bit for bit. Returns ``seq_dir``."""
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    for i, scan in enumerate(scans):
        np.ascontiguousarray(scan[:, :4], dtype=np.float32).tofile(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))
    with open(os.path.join(seq_dir, "poses.txt"), "w") as fh:
        for p in poses:
            fh.write(" ".join(f"{v:.17g}" for v in np.asarray(
                p, np.float64)[:3].reshape(-1)) + "\n")
    with open(os.path.join(seq_dir, "calib.txt"), "w") as fh:
        fh.write("Tr: " + " ".join(f"{v:.17g}" for v in np.eye(4)[:3].reshape(
            -1)) + "\n")
    return seq_dir


class KittiWindowDataset:
    """Sliding-window dataset over KITTI sequences, emitting fixed-capacity
    :class:`WindowSample`s. ``split`` selects the sequence list of the
    config; ``with_labels`` whether MOS labels and boxes are read (train,
    val) or not (test); ``window`` overrides n_past_steps (a warm-up
    window fills a suffix of the n_past_steps slots). ``seed`` and
    :meth:`set_epoch` seed each sample's draws."""

    def __init__(self, cfg, split: str, root_dir: str | None = None,
                 with_labels: bool | None = None, window: int | None = None,
                 sequences=None, cache=None, seed: int = 0):
        from .loader import ScanCache

        # consecutive windows share 9/10 scans: the cache turns the repeat
        # reads into memory copies
        self.cache = cache if cache is not None else ScanCache()
        self.cfg = cfg
        self.split = split
        self.root_dir = root_dir or os.environ.get("DATA", "")
        self.training = split == "train"
        if with_labels is None:
            with_labels = split in ("train", "val")
        self.with_labels = with_labels
        self.window = window or cfg.model.n_past_steps
        self.slots = cfg.model.n_past_steps
        if sequences is None:
            sequences = {"train": cfg.data.split_train,
                         "val": cfg.data.split_val,
                         "test": cfg.data.split_test}[split]
        self.sequences = list(sequences)
        self.augment = cfg.train.augmentation and self.training
        self.skip = max(1, round(cfg.model.delta_t_prediction
                                 / cfg.data.delta_t_data))
        self.seed = seed
        self.epoch = 0

        self.filenames: dict[int, list[str]] = {}
        self.poses: dict[int, np.ndarray] = {}
        self.index: list[tuple[int, int]] = []  # (seq, current scan idx)
        for seq in self.sequences:
            seq_dir = self._seq_dir(seq)
            self.filenames[seq] = load_files(os.path.join(seq_dir,
                                                          "velodyne"))
            if cfg.data.transform:
                self.poses[seq] = lidar_poses_from_files(
                    os.path.join(seq_dir, cfg.data.poses_file),
                    os.path.join(seq_dir, "calib.txt"))
                assert len(self.poses[seq]) == len(self.filenames[seq])
            n = max(0, len(self.filenames[seq]) - self.skip * (self.window - 1))
            for k in range(n):
                self.index.append((seq, self.skip * (self.window - 1) + k))

    def __len__(self) -> int:
        return len(self.index)

    def _seq_dir(self, seq: int) -> str:
        return os.path.join(self.root_dir, f"{int(seq):02d}")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def sample_rng(self, idx: int) -> np.random.Generator:
        """The generator of sample ``idx``'s draws in the current epoch."""
        return np.random.default_rng((self.seed, self.epoch, idx))

    def __getitem__(self, idx: int) -> WindowSample:
        seq, scan_idx = self.index[idx]
        from_idx = scan_idx - self.skip * (self.window - 1)
        past = list(range(from_idx, scan_idx + 1, self.skip))
        files = self.filenames[seq][from_idx:scan_idx + 1:self.skip]
        if not self.with_labels and not self.augment:
            return self._getitem_unlabelled(seq, scan_idx, past, files)
        rng = self.sample_rng(idx)

        scans = [self.cache.get((f, "pc"), lambda f=f: read_point_cloud(f))
                 for f in files]
        if self.cfg.data.transform:
            to_pose = self.poses[seq][past[-1]]
            for i, pts in enumerate(scans):
                pts[:, :3] = transform_point_cloud(
                    pts[:, :3], self.poses[seq][past[i]], to_pose)

        gt_boxes = labels = None
        if self.with_labels:
            bb = read_bounding_box_label(os.path.join(
                self._seq_dir(seq), "boundingbox_label",
                f"{scan_idx:06d}.npy"))
            gt_boxes = np.zeros((len(bb), 8), dtype=np.float64)
            gt_boxes[:, 0:7] = bb[:, 2:9]
            gt_boxes[:, 7] = bb[:, 0]
            lab_dir = os.path.join(self._seq_dir(seq), "labels")
            labels = [
                self.cache.get(
                    (os.path.join(lab_dir, f"{i:06d}.label"), "lab"),
                    lambda i=i: read_labels(
                        os.path.join(lab_dir, f"{i:06d}.label")))
                for i in past]

        if self.augment and gt_boxes is not None:
            counts = [len(s) for s in scans]
            allpts, boxes7 = augment_window(
                np.concatenate(scans, axis=0), gt_boxes[:, 0:7].copy(), rng)
            gt_boxes[:, 0:7] = boxes7
            scans = list(np.split(allpts, np.cumsum(counts)[:-1]))

        if self.with_labels:
            # per-scan x/y range mask (and shuffle when training); labels
            # ride along
            kept_scans, kept_labels = [], []
            prange = self.cfg.data.point_cloud_range
            for pts, lab in zip(scans, labels):
                m = mask_points_by_range(pts, prange)
                pts, lab = pts[m], (lab[m] if len(lab) == len(m) else lab)
                if self.training and self.cfg.data.shuffle:
                    perm = rng.permutation(len(pts))
                    pts, lab = pts[perm], lab[perm]
                kept_scans.append(pts)
                kept_labels.append(lab)
            scans, labels = kept_scans, kept_labels
            if self.training and gt_boxes is not None and len(gt_boxes):
                gt_boxes = gt_boxes[mask_boxes_outside_range(
                    gt_boxes[:, 0:7], prange)]

        return make_window_sample(
            scans, capacity=self.cfg.runtime.max_points_per_scan,
            window=self.slots, labels=labels, gt_boxes=gt_boxes,
            max_boxes=self.cfg.model.head.max_objs,
            meta=(seq, scan_idx, past))

    def _getitem_unlabelled(self, seq, scan_idx, past, files):
        """Label-free window: each scan read, cut to the point capacity and
        pose-aligned in float32 straight into the padded buffer (the
        arrays of the reference's native loader's numpy route)."""
        cap = self.cfg.runtime.max_points_per_scan
        n = len(files)
        if self.cfg.data.transform:
            inv_to = np.linalg.inv(self.poses[seq][past[-1]])
            tfs = np.stack([inv_to @ self.poses[seq][i]
                            for i in past]).astype(np.float32)
        else:
            tfs = np.stack([np.eye(4, dtype=np.float32)] * n)
        W = self.slots
        points = np.zeros((W, cap, 4), np.float32)
        num_points = np.zeros((W,), np.int32)
        scan_mask = np.zeros((W,), bool)
        for j, (f, tf) in enumerate(zip(files, tfs)):
            pts = self.cache.get((f, "pc"), lambda f=f: read_point_cloud(f))
            pts = pts[:cap]
            slot = W - n + j
            points[slot, :len(pts), :3] = pts[:, :3] @ tf[:3, :3].T + tf[:3, 3]
            points[slot, :len(pts), 3] = pts[:, 3]
            num_points[slot] = len(pts)
            scan_mask[slot] = True
        return WindowSample(
            points=points, num_points=num_points, scan_mask=scan_mask,
            labels=np.zeros((W, cap), np.int32),
            gt_boxes=np.zeros((self.cfg.model.head.max_objs, 8), np.float32),
            num_boxes=np.int32(0), meta=(seq, scan_idx, past))
