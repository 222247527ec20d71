"""The full InsMOS model: MotionNet -> voxelize -> UNetV2 with detection
and instance fusion -> per-point MOS logits (port of insmos_tpu/nn/model.py).

``forward(sample, train=...)`` is the training and evaluation forward: in
train mode every BatchNorm normalises with the sample's own statistics and
the new BN state comes back under "new_state". ``forward_motion`` and
``forward_tail`` are the streaming pipeline's two halves, at inference under
``torch.inference_mode``."""

from __future__ import annotations

import torch
from torch import nn

from .. import obs
from ..sparse.tensor import SparseTensor
from ..sparse.voxelize import devoxelize, voxelize_points
from .bev_backbone import BEVBackbone, bev_backbone_forward
from .center_head import CenterHead, center_head_forward, decode_and_nms
from .layers import clear_bn_state, collect_bn_state, set_bn_momentum_scale
from .minkunet4d import MotionNet, motionnet_forward
from .unet3d import UNet3D, unet3d_forward


class InsMOSModel(nn.Module):
    """Parameters under ``motion``, ``unet``, ``bev`` and ``head``, named as
    the JAX parameter tree (InsMOSModel.init)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.motion = MotionNet(cfg)
        self.unet = UNet3D(cfg)
        self.bev = BEVBackbone(cfg)
        self.head = CenterHead(cfg)
        set_bn_momentum_scale(self, cfg.train.bn_momentum_scale)

    def forward(self, sample: dict, *, train: bool = False) -> dict:
        """sample: one window's tensors (points (W, P, 4), num_points (W,),
        scan_mask (W,)). Returns the reference's outputs; with ``train``
        the graph for the gradients and "new_state", the BN state after
        this sample (state-dict entries, see layers.collect_bn_state).
        Without it no graph is built."""
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            if train:
                clear_bn_state(self)
            out = self._tail(self._motion(sample, train=train), train=train)
            if train:
                out["new_state"] = collect_bn_state(self)
            return out

    @torch.inference_mode()
    def forward_motion(self, sample: dict, *, stem_cache=None,
                       cache_shift=None, win_cache=None,
                       emit_cache: bool = False) -> dict:
        """MotionNet + voxelize of the current scan. The stem cache
        arguments select the fixed-frame incremental stem (see
        minkunet4d.motionnet_forward); the step's new "stem_cache" and
        "win" are then returned too."""
        with obs.span("motion"):
            return self._motion(sample, stem_cache=stem_cache,
                                cache_shift=cache_shift, win_cache=win_cache,
                                emit_cache=emit_cache)

    @torch.inference_mode()
    def forward_tail(self, inter: dict) -> dict:
        """UNet + detection + fusion + devoxelize, with the overflow
        counters of the reference."""
        with obs.span("tail"):
            return self._tail(inter)

    def _motion(self, sample: dict, *, train: bool = False, stem_cache=None,
                cache_shift=None, win_cache=None,
                emit_cache: bool = False) -> dict:
        cfg = self.cfg
        points = sample["points"]
        W, P = points.shape[:2]
        point_valid = (torch.arange(P, device=points.device)[None, :]
                       < sample["num_points"][:, None]) & \
            sample["scan_mask"][:, None]
        motion_cur, stats = motionnet_forward(
            self.motion, cfg, points, point_valid, train=train,
            stem_cache=stem_cache,
            cache_shift=cache_shift, win_cache=win_cache,
            emit_cache=emit_cache)
        current = points[W - 1]
        cur_valid = point_valid[W - 1]
        with obs.span("voxelize"):
            vox, p2v = voxelize_points(
                torch.cat([current, motion_cur], dim=-1), cur_valid,
                cfg.data.point_cloud_range, cfg.data.voxel_size,
                cfg.data.grid_size, cfg.model.unet_capacities[0],
                cfg.model.max_points_per_voxel,
            )
        inter = {
            "vox": vox, "p2v": p2v, "motion_cur": motion_cur,
            "current": current, "cur_valid": cur_valid,
            "motion_dropped": torch.stack(stats["dropped"]),
            "motion_span_overflow": list(stats["span_overflow"]),
        }
        for k in ("stem_cache", "win"):
            if k in stats:
                inter[k] = stats[k]
        return inter

    def _tail(self, inter: dict, *, train: bool = False) -> dict:
        cfg = self.cfg
        dtype = cfg.runtime.compute_dtype
        vox, p2v = inter["vox"], inter["p2v"]
        current, cur_valid = inter["current"], inter["cur_valid"]
        dev = current.device
        # post-voxelizer compaction: valid voxels are a sorted prefix
        cap_s = cfg.model.unet_site_capacity
        unet_dropped = torch.zeros((), dtype=torch.int64, device=dev)
        if cap_s < vox.capacity:
            unet_dropped = vox.valid[cap_s:].sum()
            vox = SparseTensor(vox.coords[:cap_s], vox.keys[:cap_s],
                               vox.feats[:cap_s], vox.valid[:cap_s], vox.dims)
            p2v = torch.where(p2v >= cap_s, -1, p2v)

        det = {}

        def boxes_fn(bev):
            with obs.span("detect"):
                feat = bev_backbone_forward(self.bev, cfg, bev, dtype, train)
                cls_map, box_map = center_head_forward(self.head, feat, dtype)
                # the fusion sees detached boxes (the reference clones and
                # detaches them); gradients reach the head through the maps
                boxes8, scores, labels, mask = decode_and_nms(
                    cfg, cls_map.detach(), box_map.detach())
            det.update(cls_map=cls_map, box_map=box_map, boxes=boxes8,
                       scores=scores, labels=labels, box_mask=mask)
            return boxes8, mask

        mos_vox_logits, _bev, unet_stats = unet3d_forward(
            self.unet, cfg, vox, boxes_fn, train)
        point_logits = devoxelize(mos_vox_logits, p2v)

        inv = 1.0 / torch.tensor(cfg.data.voxel_size, dtype=current.dtype,
                                 device=dev)
        lo = torch.tensor(cfg.data.point_cloud_range[:3], dtype=current.dtype,
                          device=dev)
        vc = torch.floor((current[:, :3] - lo) * inv).to(torch.int32)
        dims_arr = torch.tensor(cfg.data.grid_size, dtype=torch.int32,
                                device=dev)
        in_grid = ((vc >= 0) & (vc < dims_arr[None, :])).all(dim=-1)
        vox_dropped = (p2v < 0) & cur_valid
        overflow = {
            "motion_dropped": inter["motion_dropped"],
            "voxelizer_dropped": vox_dropped.sum(),
            "voxelizer_out_of_range": (vox_dropped & ~in_grid).sum(),
            "voxelizer_capacity_dropped": (vox_dropped & in_grid).sum(),
            "unet_dropped": unet_dropped,
        }
        span_ovf = inter["motion_span_overflow"] + unet_stats["span_overflow"]
        if span_ovf:  # the windowed engine has no span plans
            overflow["span_overflow"] = torch.stack(span_ovf)
        return {
            "overflow": overflow,
            "point_logits": point_logits,
            "motion_logits": inter["motion_cur"],
            "point_valid": cur_valid,
            "pc_voxel_id": p2v,
            "cls_map": det["cls_map"],
            "box_map": det["box_map"],
            "boxes": det["boxes"],
            "scores": det["scores"],
            "labels": det["labels"],
            "box_mask": det["box_mask"],
        }
