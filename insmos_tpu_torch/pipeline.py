"""Streaming inference with a device-resident scan window (port of
``InferencePipeline`` and ``fixed_frame_transform`` in
insmos_tpu/pipeline.py).

The window (points, counts, mask) lives on the device; each step uploads
one scan and one 4x4 transform, rolls the window, transforms the stored
scans and runs the model. Two modes, as in the reference:

- ref-exact (``runtime.incremental_stem=False``): the full stem runs every
  step and the stored window is re-expressed in the new current frame by
  the step's rigid transform;
- fixed-frame incremental (``runtime.incremental_stem=True``): scans are
  framed by :func:`fixed_frame_transform`, so a step's transform is a pure
  integer-voxel translation. The window's L1 site set and the stem's
  outputs (the stem cache) are carried from step to step and the stem runs
  over the new scan alone. A step whose transform is not such a
  translation (checked on the host, from the numpy transform) takes the
  full-stem recovery step instead, which rebuilds both caches and is
  counted in ``n_full_steps``.

The pipeline runs on the card unless ``device`` names the CPU.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from . import setup_device
from .nn.model import InsMOSModel
from .sparse.tensor import KEY_SENTINEL


def fixed_frame_transform(scan: np.ndarray, pose: np.ndarray,
                          prev_snap: np.ndarray | None, voxel: float = 0.1):
    """Host-side fixed-odometry framing for the incremental mode.

    Expresses the scan in a frame with the world's (odometry) orientation
    and an origin snapped to the voxel grid near the sensor, so that
    consecutive steps differ by a pure integer-voxel translation. Returns
    (scan_fixed, tf, snap): tf = inv(F_t) @ F_{t-1} is the pipeline's step
    transform (identity rotation, translation prev_snap - snap)."""
    R, t = pose[:3, :3], pose[:3, 3]
    snap = (np.round(t / voxel) * voxel).astype(np.float32)
    out = scan.astype(np.float32).copy()
    out[:, :3] = scan[:, :3] @ R.T.astype(np.float32) + (
        t.astype(np.float32) - snap
    )
    tf = np.eye(4, dtype=np.float32)
    if prev_snap is not None:
        tf[:3, 3] = prev_snap - snap
    return out, tf, snap


class InferencePipeline:
    def __init__(self, cfg, model: InsMOSModel, device="cuda"):
        self.cfg = cfg
        self.device = setup_device(device)
        self.model = model.to(self.device).eval()
        self._buf = None
        self.n_full_steps = 0  # incremental mode: recovery steps taken

    # ------------------------------------------------------------- state
    def reset(self):
        cfg = self.cfg
        W = cfg.model.n_past_steps
        P = cfg.runtime.max_points_per_scan
        dev = self.device
        buf = {
            "points": torch.zeros((W, P, 4), dtype=torch.float32, device=dev),
            "num_points": torch.zeros((W,), dtype=torch.int32, device=dev),
            "scan_mask": torch.zeros((W,), dtype=torch.bool, device=dev),
        }
        if cfg.runtime.incremental_stem:
            # an all-sentinel cache is exact for an empty window: every
            # query misses, which is zero history
            cap = cfg.model.motionnet.site_capacities[0]
            C = cfg.model.motionnet.init_dim  # the stem's output channels
            sent = torch.full((cap,), KEY_SENTINEL, dtype=torch.int32,
                              device=dev)
            buf["stem_cache"] = {
                "keys": sent,
                "feats": torch.zeros((cap, W * C), dtype=torch.float32,
                                     device=dev),
            }
            buf["win"] = {
                "keys": sent.clone(),
                "occ": torch.zeros((cap, W), dtype=torch.bool, device=dev),
            }
        self._buf = buf

    # -------------------------------------------------------------- step
    def _roll_window(self, buf, new_scan, n_new, tf):
        """Roll the window, re-express it in the new frame, insert the new
        scan. Returns (pts, num, mask)."""
        W = buf["points"].shape[0]
        pts = torch.roll(buf["points"], -1, dims=0)
        xyz = pts[..., :3] @ tf[:3, :3].T + tf[:3, 3]
        pts = torch.cat([xyz, pts[..., 3:]], dim=-1)
        pts[W - 1] = new_scan
        num = torch.roll(buf["num_points"], -1)
        num[W - 1] = n_new
        mask = torch.roll(buf["scan_mask"], -1)
        mask[W - 1] = True
        return pts, num, mask

    def _step(self, padded, n_raw, tf, shift=None, full=False):
        """One step: roll the window, run the model, carry the caches.
        In the incremental mode ``shift`` is the integer-voxel translation
        (previous-frame coords = new-frame coords + shift) and ``full``
        selects the recovery step, which runs the full stem and emits
        fresh caches."""
        dev = self.device
        buf = self._buf
        pts, num, mask = self._roll_window(
            buf, torch.from_numpy(padded).to(dev, non_blocking=True), n_raw,
            torch.from_numpy(tf).to(dev, non_blocking=True))
        new_buf = {"points": pts, "num_points": num, "scan_mask": mask}
        kw = {}
        if "stem_cache" in buf:
            kw = dict(emit_cache=True) if full else dict(
                stem_cache=buf["stem_cache"], win_cache=buf["win"],
                cache_shift=torch.from_numpy(shift).to(dev))
        inter = self.model.forward_motion(
            {"points": pts, "num_points": num, "scan_mask": mask}, **kw)
        if "stem_cache" in buf:
            new_buf["stem_cache"] = inter["stem_cache"]
            new_buf["win"] = inter["win"]
        self._buf = new_buf
        out = self.model.forward_tail(inter)
        return {k: out[k] for k in ("point_logits", "boxes", "scores",
                                    "labels", "box_mask", "overflow")}

    @torch.inference_mode()
    def push_scan(self, scan: np.ndarray, tf: np.ndarray | None = None) -> dict:
        """Feed one raw scan (N, 4) in its own sensor frame; ``tf`` is
        inv(pose_t) @ pose_{t-1} (identity when untracked). Returns the
        step's outputs as device tensors (see :meth:`fetch`).

        In the incremental mode ``tf`` is checked on the host: a rotation
        within 1e-5 of the identity and a translation within 1e-3 voxel of
        an integer k runs the incremental step with the snapped transform
        and a cache shift of -k; any other transform runs the full-stem
        recovery step (counted in ``n_full_steps``)."""
        if self._buf is None:
            self.reset()
        cap = self.cfg.runtime.max_points_per_scan
        n_raw = len(scan)
        if n_raw > cap:
            raise ValueError(f"scan has {n_raw} points > capacity {cap}")
        padded = np.zeros((cap, 4), np.float32)
        padded[:n_raw] = scan[:, :4]
        tf = np.eye(4, dtype=np.float32) if tf is None else \
            np.asarray(tf, np.float32)
        if "stem_cache" not in self._buf:
            return self._step(padded, n_raw, tf)
        vox = self.cfg.data.voxel_size[0]
        k = np.round(tf[:3, 3] / vox)
        compatible = np.allclose(tf[:3, :3], np.eye(3), atol=1e-5) and \
            np.allclose(tf[:3, 3] / vox, k, atol=1e-3)
        if not compatible:
            self.n_full_steps += 1
            return self._step(padded, n_raw, tf, full=True)
        tf_snap = np.eye(4, dtype=np.float32)
        tf_snap[:3, 3] = (k * vox).astype(np.float32)
        return self._step(padded, n_raw, tf_snap, shift=(-k).astype(np.int32))

    @staticmethod
    def fetch(out: dict, n_raw: int) -> dict[str, np.ndarray]:
        """Device outputs -> trimmed host arrays."""
        kept = out["box_mask"].cpu().numpy().astype(bool)
        return {
            "point_logits": out["point_logits"][:n_raw].cpu().numpy(),
            "boxes": out["boxes"].cpu().numpy()[kept][:, :7],
            "scores": out["scores"].cpu().numpy()[kept],
            "labels": out["labels"].cpu().numpy()[kept],
        }

    # --------------------------------------------------- window interface
    def infer_window(self, scans: list[np.ndarray]) -> dict[str, np.ndarray]:
        """scans: pose-aligned (N_i, 4) clouds, oldest..current."""
        self.reset()
        for s in scans:
            out = self.push_scan(s)
        return self.fetch(out, len(scans[-1]))

    def stream_sequence(self, scan_iter: Iterator[np.ndarray],
                        poses: np.ndarray | None, fixed_frame: bool = False
                        ) -> Iterator[dict[str, np.ndarray]]:
        """Per-scan outputs over a whole sequence, warm-up included. The
        next scan's step is queued before the previous outputs are
        fetched. ``fixed_frame`` (the incremental mode's deployment):
        each scan is first re-expressed by :func:`fixed_frame_transform`,
        so every step's transform is an integer-voxel translation."""
        self.reset()
        prev = None
        prev_pose = None
        prev_snap = None
        vox = self.cfg.data.voxel_size[0]
        for idx, scan in enumerate(scan_iter):
            tf = None
            if poses is not None:
                if fixed_frame:
                    scan, tf, prev_snap = fixed_frame_transform(
                        scan, poses[idx], prev_snap, vox)
                else:
                    tf = (np.linalg.inv(poses[idx]) @ (
                        prev_pose if prev_pose is not None else poses[idx]
                    )).astype(np.float32)
                    prev_pose = poses[idx]
            out = self.push_scan(scan, tf)
            if prev is not None:
                yield self.fetch(*prev)
            prev = (out, len(scan))
        if prev is not None:
            yield self.fetch(*prev)
