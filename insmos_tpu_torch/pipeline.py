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

The pipeline runs on the card unless ``device`` names the CPU. On the
card a step's span plans replay CUDA graphs captured at their first step
(``sparse.span_conv.PlanGraphs``, one set a pipeline); the pod's vmapped
plans run eagerly.

:class:`PodInferencePipeline` streams S sequences in lockstep, the slots
spread over the devices given (every visible card by default): on each
device one step, ``torch.func.vmap``ped over that device's slots, as the
JAX package's pod does.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Iterator

import numpy as np
import torch
from torch.utils import _pytree

from . import obs, setup_device
from .nn.model import InsMOSModel
from .sparse.span_conv import PlanGraphs
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


def window_buffers(cfg, device, lead: tuple = ()) -> dict:
    """A fresh device window (points, counts, mask) and, in the incremental
    mode, the empty stem cache and window site set, each with the leading
    axes ``lead`` (the pod's slot axis)."""
    W = cfg.model.n_past_steps
    P = cfg.runtime.max_points_per_scan
    buf = {
        "points": torch.zeros(lead + (W, P, 4), dtype=torch.float32,
                              device=device),
        "num_points": torch.zeros(lead + (W,), dtype=torch.int32,
                                  device=device),
        "scan_mask": torch.zeros(lead + (W,), dtype=torch.bool, device=device),
    }
    if cfg.runtime.incremental_stem:
        # an all-sentinel cache is exact for an empty window: every query
        # misses, which is zero history
        cap = cfg.model.motionnet.site_capacities[0]
        C = cfg.model.motionnet.init_dim  # the stem's output channels
        buf["stem_cache"] = {
            "keys": torch.full(lead + (cap,), KEY_SENTINEL, dtype=torch.int32,
                               device=device),
            "feats": torch.zeros(lead + (cap, W * C), dtype=torch.float32,
                                 device=device),
        }
        buf["win"] = {
            "keys": torch.full(lead + (cap,), KEY_SENTINEL, dtype=torch.int32,
                               device=device),
            "occ": torch.zeros(lead + (cap, W), dtype=torch.bool,
                               device=device),
        }
    return buf


class InferencePipeline:
    def __init__(self, cfg, model: InsMOSModel, device="cuda"):
        self.cfg = cfg
        self.device = setup_device(device)
        self.model = model.to(self.device).eval()
        self._buf = None
        self.n_full_steps = 0  # incremental mode: recovery steps taken
        # the step's span plans replay CUDA graphs on the card
        self.plan_graphs = PlanGraphs()

    # ------------------------------------------------------------- state
    def reset(self):
        self._buf = window_buffers(self.cfg, self.device)

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
    @staticmethod
    def _roll_window(buf, new_scan, n_new, tf):
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
        with obs.span("push"):
            pts, num, mask = self._roll_window(
                buf, torch.from_numpy(padded).to(dev, non_blocking=True),
                n_raw, torch.from_numpy(tf).to(dev, non_blocking=True))
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
        with obs.step(1):
            obs.count("pipeline.steps")
            obs.count("pipeline.scans")
            with obs.span("push"):
                if self._buf is None:
                    self.reset()
                padded, n_raw = self._pad(scan)
                tf = np.eye(4, dtype=np.float32) if tf is None else \
                    np.asarray(tf, np.float32)
                args, full = (padded, n_raw, tf), False
                if "stem_cache" in self._buf:
                    snapped = voxel_translation(tf,
                                                self.cfg.data.voxel_size[0])
                    if snapped is None:
                        self.n_full_steps += 1
                        full = True
                    else:
                        args = (padded, n_raw, *snapped)
            with self.plan_graphs.step():
                return self._step(*args, full=full)

    @staticmethod
    def fetch(out: dict, n_raw: int) -> dict[str, np.ndarray]:
        """Device outputs -> trimmed host arrays."""
        with obs.span("fetch"):
            return _host_outputs(out, n_raw)

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


def _host_outputs(out: dict, n_raw: int) -> dict[str, np.ndarray]:
    with obs.span("sync.fetch"):
        mask = out["box_mask"].cpu().numpy()
        logits = out["point_logits"][:n_raw].cpu().numpy()
        boxes, scores, labels = (out[k].cpu().numpy()
                                 for k in ("boxes", "scores", "labels"))
    kept = mask.astype(bool)
    return {"point_logits": logits, "boxes": boxes[kept][:, :7],
            "scores": scores[kept], "labels": labels[kept]}


OUT_KEYS = ("point_logits", "boxes", "scores", "labels", "box_mask",
            "overflow")


@contextlib.contextmanager
def no_vmap_fallback():
    """vmap's per-slot fallback off: an op with no batching rule raises
    instead of running slot by slot. Restored on exit."""
    functorch = torch._C._functorch
    prev = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        functorch._set_vmap_fallback_enabled(prev)


class PodInferencePipeline:
    """Streaming multi-sequence inference (the port of the JAX package's
    ``PodInferencePipeline``): S sequence streams advance in lockstep, one
    scan per stream per step.

    ``n_slots = len(devices) * slots_per_device``; slot i lives on device
    ``i // slots_per_device``. Each device holds one model replica (the
    first is ``model`` itself, the others deep copies) and one stacked
    window of its slots, ``(S_d, W, P, 4)`` and so on, with the incremental
    mode's stem cache and window site set. ``devices`` defaults to every
    visible CUDA device; the CPU runs only when the caller names it.

    A step is, on each device, the single-stream step ``torch.func.vmap``ped
    over the device's slots, as two passes (motion, then tail), exactly as
    the JAX package vmaps its step: each glue op, each span-plan pass, the
    NMS and each span-conv kernel launch serve every slot of the device at
    once (the span conv's and the NMS's batching rules, span_conv.py and
    ops/nms.py). vmap's per-slot fallback is off during the step, so an op
    without a batching rule raises instead of looping over slots. Idle slots
    step on an empty scan with their window kept (``torch.where(active,
    new, old)``); their outputs are zeros. Devices step one after another.

    In the incremental mode every active slot's transform must be an
    integer-voxel translation (scans framed by
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
        self.devices = [setup_device(d) for d in devices]
        self.models = [(model if j == 0 else copy.deepcopy(model)).to(d).eval()
                       for j, d in enumerate(self.devices)]
        self.n_slots = len(self.devices) * self.slots_per_device
        self.device = self.devices[0]
        self._buf = None  # one stacked window per device

    def reset(self):
        self._buf = [window_buffers(self.cfg, d, (self.slots_per_device,))
                     for d in self.devices]

    def _device_step(self, j, padded, ns, tfs, shifts, active) -> dict:
        """Device j's vmapped step over its slots (host arrays, one row a
        slot). Returns its outputs (S_d, ...), zeros on idle slots."""
        dev, model = self.devices[j], self.models[j]
        incremental = self.cfg.runtime.incremental_stem

        def motion(buf, scan, n, tf, shift, act):
            pts, num, mask = InferencePipeline._roll_window(buf, scan, n, tf)
            kw = dict(stem_cache=buf["stem_cache"], win_cache=buf["win"],
                      cache_shift=shift) if incremental else {}
            inter = model.forward_motion(
                {"points": pts, "num_points": num, "scan_mask": mask}, **kw)
            new = {"points": pts, "num_points": num, "scan_mask": mask}
            if incremental:
                new["stem_cache"] = inter.pop("stem_cache")
                new["win"] = inter.pop("win")
            # an idle slot keeps its window and caches untouched
            new = _pytree.tree_map(lambda a, b: torch.where(act, a, b), new,
                                   buf)
            return new, inter

        def tail(inter):
            out = model.forward_tail(inter)
            return {k: out[k] for k in OUT_KEYS}

        with obs.span("push"):
            args = [torch.from_numpy(a).to(dev, non_blocking=True)
                    for a in (padded, ns, tfs, shifts, active)]
        with no_vmap_fallback():
            self._buf[j], inter = torch.func.vmap(motion)(self._buf[j], *args)
            out = torch.func.vmap(tail)(inter)
        act = args[-1]
        return _pytree.tree_map(
            lambda x: torch.where(act.reshape((-1,) + (1,) * (x.dim() - 1)),
                                  x, torch.zeros((), dtype=x.dtype,
                                                 device=dev)), out)

    @torch.inference_mode()
    def push_scans(self, scans, tfs=None) -> dict:
        """scans: S arrays (N_i, 4), or None for an idle slot; tfs: S (4, 4)
        step transforms or None (identity). Returns the step's outputs
        batched (S, ...) on the first device, with the single-stream keys
        (``overflow`` a dict of (S, ...) counters); trim one slot's with
        :meth:`fetch`. An idle slot's window is left untouched and its rows
        are zeros with ``box_mask`` all False, which no caller reads."""
        with obs.step(self.n_slots):
            with obs.span("push"):
                arrays = self._host_inputs(scans, tfs)
                if self._buf is None:
                    self.reset()
            obs.count("pipeline.steps")
            obs.count("pipeline.scans", int(arrays[-1].sum()))
            D = self.slots_per_device
            outs = [self._device_step(j, *(a[j * D:(j + 1) * D]
                                           for a in arrays))
                    for j in range(len(self.devices))]
            return _pytree.tree_map(
                lambda *xs: torch.cat([x.to(self.device) for x in xs]), *outs)

    def _host_inputs(self, scans, tfs):
        """The step's host arrays, one row a slot: (padded scans, counts,
        transforms, cache shifts, active)."""
        if len(scans) != self.n_slots:
            raise ValueError(f"{len(scans)} scans for {self.n_slots} slots")
        if all(scan is None for scan in scans):
            raise ValueError("every slot is idle")
        S = self.n_slots
        cap = self.cfg.runtime.max_points_per_scan
        vox = self.cfg.data.voxel_size[0]
        padded = np.zeros((S, cap, 4), np.float32)
        ns = np.zeros((S,), np.int32)
        active = np.zeros((S,), bool)
        tfa = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
        shifts = np.zeros((S, 3), np.int32)
        for i, scan in enumerate(scans):
            if scan is None:
                continue
            if len(scan) > cap:
                raise ValueError(f"slot {i}: scan has {len(scan)} points > "
                                 f"capacity {cap}")
            padded[i, :len(scan)] = scan[:, :4]
            ns[i] = len(scan)
            active[i] = True
            if tfs is not None and tfs[i] is not None:
                tfa[i] = np.asarray(tfs[i], np.float32)
            if self.cfg.runtime.incremental_stem:
                snapped = voxel_translation(tfa[i], vox)
                if snapped is None:
                    raise ValueError(
                        f"slot {i}: tf is not an integer-voxel translation; "
                        "feed fixed_frame_transform'd scans in the "
                        "incremental pod mode")
                tfa[i], shifts[i] = snapped
        return padded, ns, tfa, shifts, active

    @staticmethod
    def fetch(out: dict, i: int, n_raw: int) -> dict[str, np.ndarray]:
        """Slot ``i``'s outputs -> trimmed host arrays."""
        with obs.span("fetch"):
            return _host_outputs(
                {k: out[k][i] for k in OUT_KEYS if k != "overflow"}, n_raw)
