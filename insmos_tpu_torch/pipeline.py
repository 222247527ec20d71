"""Streaming inference with a device-resident scan window (port of
``InferencePipeline`` in insmos_tpu/pipeline.py), ref-exact mode: the full
stem runs every step and the stored window is re-expressed in the new
current frame by the step's rigid transform.

The window (points, counts, mask) lives on the device; each step uploads
one scan and one 4x4 transform, rolls the window, transforms the stored
scans and runs the model. The incremental (fixed-frame) stem is not ported
yet: a config with ``runtime.incremental_stem`` is refused. The pipeline
runs on the card unless ``device`` names the CPU.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from . import setup_device
from .nn.model import InsMOSModel


class InferencePipeline:
    def __init__(self, cfg, model: InsMOSModel, device="cuda"):
        if cfg.runtime.incremental_stem:
            raise NotImplementedError(
                "the incremental stem is not ported; use incremental_stem=False")
        self.cfg = cfg
        self.device = setup_device(device)
        self.model = model.to(self.device).eval()
        self._buf = None

    # ------------------------------------------------------------- state
    def reset(self):
        W = self.cfg.model.n_past_steps
        P = self.cfg.runtime.max_points_per_scan
        dev = self.device
        self._buf = {
            "points": torch.zeros((W, P, 4), dtype=torch.float32, device=dev),
            "num_points": torch.zeros((W,), dtype=torch.int32, device=dev),
            "scan_mask": torch.zeros((W,), dtype=torch.bool, device=dev),
        }

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

    @torch.inference_mode()
    def push_scan(self, scan: np.ndarray, tf: np.ndarray | None = None) -> dict:
        """Feed one raw scan (N, 4) in its own sensor frame; ``tf`` is
        inv(pose_t) @ pose_{t-1} (identity when untracked). Returns the
        step's outputs as device tensors (see :meth:`fetch`)."""
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
        dev = self.device
        pts, num, mask = self._roll_window(
            self._buf, torch.from_numpy(padded).to(dev, non_blocking=True),
            n_raw, torch.from_numpy(tf).to(dev, non_blocking=True))
        self._buf = {"points": pts, "num_points": num, "scan_mask": mask}
        out = self.model.forward({"points": pts, "num_points": num,
                                  "scan_mask": mask})
        return {k: out[k] for k in ("point_logits", "boxes", "scores",
                                    "labels", "box_mask", "overflow")}

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
                        poses: np.ndarray | None
                        ) -> Iterator[dict[str, np.ndarray]]:
        """Per-scan outputs over a whole sequence, warm-up included. The
        next scan's step is queued before the previous outputs are
        fetched."""
        self.reset()
        prev = None
        prev_pose = None
        for idx, scan in enumerate(scan_iter):
            tf = None
            if poses is not None:
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
