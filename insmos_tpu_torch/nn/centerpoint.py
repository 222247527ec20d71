"""CenterPoint, voxel variant (``centerpoint_config.py``): the sweep window
merged into one cloud, MeanVFE, VoxelResBackBone8x, HeightCompression,
the two-level BEV backbone, the grouped CenterPoint head, decode and
per-group NMS.

The streaming step is three methods, each under its own span:
``forward_backbone3d`` (sweeps to the dense BEV), ``forward_dense`` (BEV
backbone and heads) and ``forward_post`` (decode and NMS). Every shape is
fixed by the configuration's capacities, so nothing waits on a size the
data decides; the NMS copies the candidates' overlaps to the host once a
step, for all six groups.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import obs
from ..sparse.bev import to_dense_bev
from ..sparse.coords import linearize_coords
from ..sparse.slab import _first_of_run, sparse_from_slab
from ..sparse.tensor import KEY_SENTINEL, SparseTensor
from ..sparse.voxelize import voxelize_points
from .bev_backbone import BEVBackbone, bev_backbone_forward
from .center_head_groups import (CenterHeadGroups, center_head_groups_forward,
                                 decode_groups, label_table, nms_groups)
from .voxel_res_backbone import VoxelResBackBone8x, backbone3d_forward


def merge_sweeps(cfg, window: dict):
    """The window (points (W, P, 4) in the newest sweep's frame, oldest
    first; num_points (W,); scan_mask (W,); near (W, P): a point within
    the ego box in its own sensor frame) -> one cloud (W * P, 5) of x, y,
    z, intensity and lag, the newest sweep first and then by age, with
    its validity (W * P,): older sweeps lose their ego-box points."""
    pts = window["points"].flip(0)
    W, P = pts.shape[:2]
    dev = pts.device
    age = torch.arange(W, device=dev)
    valid = ((torch.arange(P, device=dev)[None] <
              window["num_points"].flip(0)[:, None])
             & window["scan_mask"].flip(0)[:, None]
             & ~(window["near"].flip(0) & (age > 0)[:, None]))
    lag = age.to(torch.float32) * cfg.sweeps.sweep_dt
    feats = torch.cat([pts, lag[:, None, None].expand(W, P, 1)], dim=-1)
    return feats.reshape(W * P, 5), valid.reshape(W * P)


def ego_box(cfg, scan) -> torch.Tensor:
    """(P,) bool: the points of a sweep (in its own sensor frame) inside
    the ego box, |x| and |y| under ``ego_radius``."""
    r = cfg.sweeps.ego_radius
    return (scan[:, 0].abs() < r) & (scan[:, 1].abs() < r)


def _distinct(keys) -> torch.Tensor:
    """Distinct keys other than the sentinel (one sort, no host sync)."""
    sk = torch.sort(keys).values
    return (_first_of_run(sk) & (sk != KEY_SENTINEL)).sum()


class CenterPointModel(nn.Module):
    """Parameters under ``backbone3d``, ``bev`` and ``head``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.backbone3d = VoxelResBackBone8x(cfg)
        self.bev = BEVBackbone(cfg)
        self.head = CenterHeadGroups(cfg)
        self.register_buffer("label_table", label_table(cfg),
                             persistent=False)
        # the voxelizer's float32 constants, uploaded once
        d = cfg.data
        self.register_buffer("vox_lo", torch.tensor(
            d.point_cloud_range[:3], dtype=torch.float32), persistent=False)
        self.register_buffer("vox_inv", 1.0 / torch.tensor(
            d.voxel_size, dtype=torch.float32), persistent=False)

    @torch.inference_mode()
    def forward_backbone3d(self, window: dict) -> dict:
        """Merge, voxelize, the sparse backbone and the dense BEV (H, W,
        256), with the step's gate counters and counts."""
        with obs.span("backbone3d"):
            return self._backbone3d(window)

    @torch.inference_mode()
    def forward_dense(self, inter: dict) -> dict:
        """The BEV backbone and the heads: per group {head: (c, H, W)}."""
        with obs.span("dense"):
            cfg = self.cfg
            dtype = cfg.runtime.compute_dtype
            feat = bev_backbone_forward(self.bev, cfg, inter["bev"], dtype)
            maps = center_head_groups_forward(self.head, cfg, feat, dtype)
            return dict(inter, maps=maps)

    @torch.inference_mode()
    def forward_post(self, inter: dict) -> dict:
        """Decode and per-group NMS: boxes (G * M, 9), scores, labels,
        box_mask, ``overflow`` (the gates) and ``counts``."""
        with obs.span("post"):
            cfg = self.cfg
            boxes, scores, labels, cand = decode_groups(
                cfg, inter["maps"], self.label_table)
            b, s, lab, mask = nms_groups(cfg, boxes, scores, labels, cand)
            counts = torch.cat([inter["counts"],
                                cand.sum().reshape(1).to(torch.int64)])
            return {"boxes": b, "scores": s, "labels": lab, "box_mask": mask,
                    "overflow": inter["overflow"], "counts": counts}

    def _backbone3d(self, window: dict) -> dict:
        cfg = self.cfg
        d = cfg.data
        feats, valid = merge_sweeps(cfg, window)
        grid = d.grid_size
        with obs.span("voxelize"):
            vox, p2v = voxelize_points(
                feats, valid, d.point_cloud_range, d.voxel_size, grid,
                cfg.model.backbone.max_voxels,
                cfg.model.backbone.max_points_per_voxel)
            # the voxelizer's coordinates again: in range, and the ones
            # whose voxel the capacity dropped
            vc = torch.floor((feats[:, :3] - self.vox_lo)
                             * self.vox_inv).to(torch.int32)
            keys = linearize_coords(vc, grid, valid)
            in_range = keys != KEY_SENTINEL
            lost = linearize_coords(vc, grid, in_range & (p2v < 0))
            n_dropped = _distinct(lost)
        # the grid's keys are the sparse shape's: z is the slowest axis
        x = SparseTensor(vox.coords, vox.keys, vox.feats, vox.valid,
                         d.sparse_shape)
        enc, stats = backbone3d_forward(self.backbone3d, cfg, x,
                                        cfg.runtime.compute_dtype)
        bev = to_dense_bev(sparse_from_slab(enc))
        counts = torch.stack([in_range.sum(), vox.valid.sum(), n_dropped])
        overflow = {"voxels_dropped": n_dropped.reshape(1),
                    "span_overflow": stats["span_overflow"],
                    "sites_dropped": stats["sites_dropped"]}
        return {"bev": bev, "overflow": overflow, "counts": counts}
