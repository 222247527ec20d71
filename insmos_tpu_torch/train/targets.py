"""CenterHead target assignment over all boxes at once (port of
insmos_tpu/train/targets.py): per box a gaussian on the stride-4 BEV
heatmap, the box code [dx, dy, z, log dims, sin, cos], the flat index
y*W + x and a validity mask."""

from __future__ import annotations

import torch

from ..ops.gaussian import gaussian_radius, splat_gaussians


def assign_targets(cfg, gt_boxes, num_boxes):
    """gt_boxes (M, 8) [x,y,z,dx,dy,dz,yaw,class], class 1-indexed, zero
    padded. Returns dict(heatmap (C, H, W), anno (M, 8), inds (M,), mask
    (M,))."""
    h = cfg.model.head
    vx, vy = cfg.data.voxel_size[:2]
    gx, gy, _ = cfg.data.grid_size
    W, H = gx // h.out_size_factor, gy // h.out_size_factor
    rng = cfg.data.point_cloud_range
    M = gt_boxes.shape[0]
    dev = gt_boxes.device

    cls_id = gt_boxes[:, 7].to(torch.int32) - 1
    row_ok = torch.arange(M, device=dev) < num_boxes
    # width/length in heatmap cells (the reference swaps the names)
    width = gt_boxes[:, 3] / vx / h.out_size_factor
    length = gt_boxes[:, 4] / vy / h.out_size_factor
    ok = row_ok & (width > 0) & (length > 0) & (cls_id > -1)

    radius = gaussian_radius(length, width, h.gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=h.min_radius)

    coor_x = (gt_boxes[:, 0] - rng[0]) / vx / h.out_size_factor
    coor_y = (gt_boxes[:, 1] - rng[1]) / vy / h.out_size_factor
    cx = coor_x.to(torch.int32)  # truncation toward zero
    cy = coor_y.to(torch.int32)
    ok = ok & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)

    heatmap = splat_gaussians(
        (h.num_class, H, W), torch.stack([cx, cy], dim=-1), radius,
        torch.clamp(cls_id, 0, h.num_class - 1), ok,
        max_radius=h.max_gaussian_radius)
    anno = torch.cat([
        (coor_x - cx)[:, None], (coor_y - cy)[:, None], gt_boxes[:, 2:3],
        torch.log(torch.clamp(gt_boxes[:, 3:6], min=1e-12)),
        torch.sin(gt_boxes[:, 6:7]), torch.cos(gt_boxes[:, 6:7]),
    ], dim=-1)
    inds = torch.clamp(cy * W + cx, 0, H * W - 1)
    return {"heatmap": heatmap,
            "anno": torch.where(ok[:, None], anno, 0.0),
            "inds": torch.where(ok, inds, 0),
            "mask": ok}
