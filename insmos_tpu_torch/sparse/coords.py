"""Coordinate linearization and sorted-key lookup (port of
insmos_tpu/sparse/coords.py)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .tensor import KEY_SENTINEL


def check_dims(dims: Sequence[int]) -> None:
    total = math.prod(dims)
    if total >= 2**31 - 1:
        raise ValueError(f"grid {dims} overflows int32 keys ({total})")


def linearize_coords(coords, dims: Sequence[int], valid=None):
    """(N, D) int coords -> (N,) int32 keys, x fastest; out-of-grid or
    invalid rows -> KEY_SENTINEL."""
    check_dims(dims)
    coords = coords.to(torch.int64)
    key = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    in_grid = torch.ones(coords.shape[:-1], dtype=torch.bool, device=coords.device)
    for d in reversed(range(len(dims))):
        c = coords[..., d]
        in_grid = in_grid & (c >= 0) & (c < dims[d])
        key = key * dims[d] + c.clamp(0, dims[d] - 1)
    if valid is not None:
        in_grid = in_grid & valid
    return torch.where(in_grid, key, KEY_SENTINEL).to(torch.int32)


def delinearize_key(keys, dims: Sequence[int]):
    """Inverse of linearize_coords for valid keys: (N,) -> (N, D) int32."""
    cols = []
    k = keys.to(torch.int64)
    for d in range(len(dims)):
        cols.append((k % dims[d]).to(torch.int32))
        k = k // dims[d]
    return torch.stack(cols, dim=-1)


def lookup_keys(sorted_keys, query_keys):
    """(Q,) query keys -> (Q,) int32 row in sorted_keys, or -1 if absent.
    Sentinel queries never match."""
    n = sorted_keys.shape[0]
    idx = torch.searchsorted(sorted_keys, query_keys.contiguous()).clamp(0, n - 1)
    hit = (sorted_keys[idx] == query_keys) & (query_keys != KEY_SENTINEL)
    return torch.where(hit, idx, -1).to(torch.int32)
