"""Gaussian heatmap targets, vectorised (port of insmos_tpu/ops/gaussian.py):
a scatter-max of fixed-size gaussian patches over all boxes at once, in
place of the reference's per-object loop."""

from __future__ import annotations

import numpy as np
import torch


def gaussian_radius(height, width, min_overlap: float):
    """CornerNet-style radius (height/width in heatmap cells)."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1**2 - 4 * a1 * c1, min=0.0))) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2**2 - 4 * a2 * c2, min=0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3**2 - 4 * a3 * c3, min=0.0))) / (
        2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat_gaussians(heatmap_shape, centers_int, radii, class_ids, valid,
                    max_radius: int):
    """Scatter-max gaussian patches into a (C, H, W) heatmap: sigma =
    (2r+1)/6, values below float32 eps zeroed, each patch cut at r and at
    the map border. centers_int (M, 2) int (x, y), radii (M,), class_ids
    (M,) in [0, C), valid (M,)."""
    C, H, W = heatmap_shape
    R = max_radius
    dev = centers_int.device
    ar = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")  # (P, P)
    r = torch.clamp(radii, 0, R).to(torch.float32)
    sigma = (2.0 * r + 1.0) / 6.0
    d2 = (dx[None] ** 2 + dy[None] ** 2).to(torch.float32)
    val = torch.exp(-d2 / (2.0 * sigma[:, None, None] ** 2))
    in_radius = (dx.abs()[None] <= r[:, None, None]) & (
        dy.abs()[None] <= r[:, None, None])
    val = torch.where(in_radius, val, 0.0)
    val = torch.where(val < np.finfo(np.float32).eps, 0.0, val)

    px = centers_int[:, 0, None, None] + dx[None]
    py = centers_int[:, 1, None, None] + dy[None]
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & valid[:, None, None]
    flat = class_ids.to(torch.int64)[:, None, None] * (H * W) + py * W + px
    flat = torch.where(inb, flat, C * H * W)  # out of range -> the dump cell
    heat = torch.zeros(C * H * W + 1, dtype=torch.float32, device=dev)
    heat = heat.scatter_reduce(0, flat.reshape(-1), val.reshape(-1),
                               reduce="amax")
    return heat[:-1].reshape(C, H, W)
