"""Box decode for the CenterPoint-style head (port of
insmos_tpu/ops/box_utils.py)."""

from __future__ import annotations

import torch

from .iou3d import boxes_to_corners_bev  # noqa: F401  (re-export)


def decode_center_boxes(box_preds, voxel_size, pc_range, out_size_factor: int):
    """Dense (H, W, 8) regression map -> (H*W, 7) world-frame boxes: grid
    cell plus offset scaled to metres, dims through exp, yaw by atan2."""
    H, W, _ = box_preds.shape
    flat = box_preds.reshape(H * W, 8)
    ys, xs = torch.meshgrid(torch.arange(H, device=flat.device),
                            torch.arange(W, device=flat.device), indexing="ij")
    xs = xs.reshape(-1) + flat[:, 0]
    ys = ys.reshape(-1) + flat[:, 1]
    xs = xs * out_size_factor * voxel_size[0] + pc_range[0]
    ys = ys * out_size_factor * voxel_size[1] + pc_range[1]
    dims = torch.exp(flat[:, 3:6])
    yaw = torch.atan2(flat[:, 6], flat[:, 7])
    return torch.cat([torch.stack([xs, ys, flat[:, 2]], -1), dims,
                      yaw[:, None]], dim=-1)
