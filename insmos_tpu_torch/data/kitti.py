"""KITTI odometry / SemanticKITTI-MOS file helpers (the port's own copy of
the IO half of ``insmos_tpu/data/kitti.py``; tests/test_torch_cli.py holds
the two equal).

Host-side numpy, with the reference loaders' semantics: KITTI pose and
calib parsing, the camera-to-LiDAR pose conversion with the first frame as
origin, the label decode, and the bounding-box label decode with its class
merge and fake-box rule. The sliding-window training dataset is not carried
over. :func:`write_sequence`, the readers' inverse for scans and poses, is
the port's own.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import map_semantic_labels, merge_det_class


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
