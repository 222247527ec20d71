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

:class:`PodInferencePipeline` streams S sequences in lockstep, one
single-stream pipeline a slot, the slots spread over the devices given
(every visible card by default).
"""

from __future__ import annotations

import copy
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


def framed_scans(scans: Iterator[np.ndarray], poses: np.ndarray | None,
                 fixed_frame: bool = False, voxel: float = 0.1
                 ) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
    """(scan, tf) for each scan of a sequence, as a pipeline step takes
    them. With ``poses``, tf = inv(pose_t) @ pose_{t-1} (the identity on the
    first scan); with ``fixed_frame`` too, the scan is first re-expressed by
    :func:`fixed_frame_transform` and tf is its integer-voxel step. Without
    poses, the scan as read and no transform."""
    prev_pose = prev_snap = None
    for idx, scan in enumerate(scans):
        tf = None
        if poses is not None:
            if fixed_frame:
                scan, tf, prev_snap = fixed_frame_transform(
                    scan, poses[idx], prev_snap, voxel)
            else:
                tf = (np.linalg.inv(poses[idx]) @ (
                    prev_pose if prev_pose is not None else poses[idx]
                )).astype(np.float32)
                prev_pose = poses[idx]
        yield scan, tf


def voxel_translation(tf: np.ndarray, voxel: float):
    """The incremental mode's check of a step transform: a rotation within
    1e-5 of the identity and a translation within 1e-3 voxel of an integer
    k give (the snapped transform, the cache shift -k as int32); any other
    transform gives None."""
    k = np.round(tf[:3, 3] / voxel)
    if not (np.allclose(tf[:3, :3], np.eye(3), atol=1e-5)
            and np.allclose(tf[:3, 3] / voxel, k, atol=1e-3)):
        return None
    tf_snap = np.eye(4, dtype=np.float32)
    tf_snap[:3, 3] = (k * voxel).astype(np.float32)
    return tf_snap, (-k).astype(np.int32)


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

    def _pad(self, scan: np.ndarray):
        """The scan in a zero-padded (capacity, 4) buffer, and its count."""
        cap = self.cfg.runtime.max_points_per_scan
        n_raw = len(scan)
        if n_raw > cap:
            raise ValueError(f"scan has {n_raw} points > capacity {cap}")
        padded = np.zeros((cap, 4), np.float32)
        padded[:n_raw] = scan[:, :4]
        return padded, n_raw

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
        padded, n_raw = self._pad(scan)
        tf = np.eye(4, dtype=np.float32) if tf is None else \
            np.asarray(tf, np.float32)
        if "stem_cache" not in self._buf:
            return self._step(padded, n_raw, tf)
        snapped = voxel_translation(tf, self.cfg.data.voxel_size[0])
        if snapped is None:
            self.n_full_steps += 1
            return self._step(padded, n_raw, tf, full=True)
        return self._step(padded, n_raw, *snapped)

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
        so every step's transform is an integer-voxel translation
        (:func:`framed_scans`)."""
        self.reset()
        prev = None
        for scan, tf in framed_scans(scan_iter, poses, fixed_frame,
                                     self.cfg.data.voxel_size[0]):
            out = self.push_scan(scan, tf)
            if prev is not None:
                yield self.fetch(*prev)
            prev = (out, len(scan))
        if prev is not None:
            yield self.fetch(*prev)


OUT_KEYS = ("point_logits", "boxes", "scores", "labels", "box_mask",
            "overflow")


class PodInferencePipeline:
    """Streaming multi-sequence inference (the port of the JAX package's
    ``PodInferencePipeline``): S sequence streams advance in lockstep, one
    scan per stream per step.

    ``n_slots = len(devices) * slots_per_device``; slot i lives on device
    ``i // slots_per_device``. Each device holds one model replica (the
    first is ``model`` itself, the others deep copies), so on one card all
    slots share the one model. ``devices`` defaults to every visible CUDA
    device; the CPU runs only when the caller names it. Each slot is a
    single-stream :class:`InferencePipeline` with its own ring window and,
    in the incremental mode, its own stem cache and window site set.

    A step runs each active slot's single-stream step, one slot after
    another; the JAX package vmaps one step over the slot axis instead,
    which gives the same outputs. In the incremental mode every active
    slot's transform must be an integer-voxel translation (scans framed by
    :func:`fixed_frame_transform`): the pod has no per-slot full-stem
    recovery step, so any other transform raises ``ValueError`` before any
    slot steps."""

    def __init__(self, cfg, model: InsMOSModel, devices=None,
                 slots_per_device: int = 1):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("no CUDA device: name the CPU "
                                   "(devices=['cpu']) to run there")
        self.cfg = cfg
        self.slots_per_device = int(slots_per_device)
        replicas = [model if j == 0 else copy.deepcopy(model)
                    for j in range(len(devices))]
        self.slots = [
            InferencePipeline(cfg, replicas[i // self.slots_per_device],
                              devices[i // self.slots_per_device])
            for i in range(len(devices) * self.slots_per_device)]
        self.n_slots = len(self.slots)
        self.device = self.slots[0].device

    def reset(self):
        for slot in self.slots:
            slot.reset()

    @torch.inference_mode()
    def push_scans(self, scans, tfs=None) -> dict:
        """scans: S arrays (N_i, 4), or None for an idle slot; tfs: S (4, 4)
        step transforms or None (identity). Returns the step's outputs
        batched (S, ...) on the first device, with the single-stream keys
        (``overflow`` a dict of (S, ...) counters); trim one slot's with
        :meth:`fetch`. An idle slot does not step: its window is left
        untouched and its rows are zeros with ``box_mask`` all False, which
        no caller reads."""
        if len(scans) != self.n_slots:
            raise ValueError(f"{len(scans)} scans for {self.n_slots} slots")
        vox = self.cfg.data.voxel_size[0]
        steps = {}
        for i, scan in enumerate(scans):
            if scan is None:
                continue
            tf = (np.eye(4, dtype=np.float32)
                  if tfs is None or tfs[i] is None
                  else np.asarray(tfs[i], np.float32))
            shift = None
            if self.cfg.runtime.incremental_stem:
                snapped = voxel_translation(tf, vox)
                if snapped is None:
                    raise ValueError(
                        f"slot {i}: tf is not an integer-voxel translation; "
                        "feed fixed_frame_transform'd scans in the "
                        "incremental pod mode")
                tf, shift = snapped
            steps[i] = (*self.slots[i]._pad(scan), tf, shift)
        if not steps:
            raise ValueError("every slot is idle")
        outs = {}
        for i, args in steps.items():
            slot = self.slots[i]
            if slot._buf is None:
                slot.reset()
            outs[i] = slot._step(*args)
        like = next(iter(outs.values()))
        dev = self.device

        def stack(get):
            ref = get(like)
            return torch.stack([
                get(outs[i]).to(dev) if i in outs else
                torch.zeros_like(ref, device=dev)
                for i in range(self.n_slots)])

        out = {k: stack(lambda o, k=k: o[k]) for k in OUT_KEYS
               if k != "overflow"}
        out["overflow"] = {k: stack(lambda o, k=k: o["overflow"][k])
                           for k in like["overflow"]}
        return out

    @staticmethod
    def fetch(out: dict, i: int, n_raw: int) -> dict[str, np.ndarray]:
        """Slot ``i``'s outputs -> trimmed host arrays."""
        return InferencePipeline.fetch(
            {k: out[k][i] for k in OUT_KEYS if k != "overflow"}, n_raw)
