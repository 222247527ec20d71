"""Sparse -> dense BEV projection (port of insmos_tpu/sparse/bev.py)."""

from __future__ import annotations

import torch

from .tensor import SparseTensor


def to_dense_bev(x: SparseTensor) -> torch.Tensor:
    """(V voxels over dims (X, Y, Z)) -> (Y, X, C*Z) dense BEV, HWC, with
    channel = c*Z + z (the reference's (C, D, H, W) -> (C*D, H, W))."""
    X, Y, Z = x.dims
    C = x.num_features
    feats = torch.where(x.valid[:, None], x.feats, 0.0)
    cx, cy, cz = (x.coords[:, i].to(torch.int64) for i in range(3))
    flat = torch.where(x.valid, cy * (X * Z) + cx * Z + cz, Y * X * Z)
    dense = torch.zeros((Y * X * Z + 1, C), dtype=feats.dtype,
                        device=feats.device).index_put((flat,), feats)
    dense = dense[:-1].reshape(Y, X, Z, C)
    return dense.permute(0, 1, 3, 2).reshape(Y, X, C * Z)
