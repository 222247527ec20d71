"""Point -> voxel set construction and back (port of
insmos_tpu/sparse/voxelize.py): one stable sort plus segment reductions,
static shapes."""

from __future__ import annotations

import torch

from .coords import delinearize_key, linearize_coords
from .tensor import KEY_SENTINEL, SparseTensor

_I32_MAX = 2**31 - 1


def unique_voxels(coords, dims, capacity: int, point_valid=None,
                  first_occurrence_cap: bool = True):
    """Deduplicate integer point coordinates into a sorted voxel set.

    Returns (SparseTensor of sites (empty feats), point_to_voxel (N,) int32,
    slot (N,) int32 position of each point within its voxel, counts (V,)).
    Beyond ``capacity`` voxels, voxels are kept by order of first point
    occurrence (spconv PointToVoxel) when first_occurrence_cap, else by key;
    dropped points get point_to_voxel = -1."""
    dev = coords.device
    n = coords.shape[0]
    keys = linearize_coords(coords, dims, point_valid)
    sk, perm = torch.sort(keys, stable=True)
    is_first = torch.cat([torch.ones_like(sk[:1], dtype=torch.bool),
                          sk[1:] != sk[:-1]]) & (sk != KEY_SENTINEL)
    group = torch.cumsum(is_first.to(torch.int64), 0) - 1
    group = torch.where(sk == KEY_SENTINEL, -1, group)
    n_groups = torch.clamp(group.max() + 1, min=0)
    gsafe = group.clamp(min=0)

    sorted_pos = torch.arange(n, device=dev)
    group_start = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gsafe, torch.where(is_first, sorted_pos, 0), reduce="amax")
    slot_sorted = sorted_pos - group_start[gsafe]
    first_idx = torch.full((n,), _I32_MAX, dtype=torch.int64,
                           device=dev).scatter_reduce(
        0, gsafe, torch.where(group >= 0, perm, _I32_MAX), reduce="amin")
    counts_full = torch.zeros(n, dtype=torch.int64, device=dev).index_add(
        0, gsafe, (group >= 0).to(torch.int64))

    group_alive = torch.arange(n, device=dev) < n_groups
    if first_occurrence_cap:
        occ_key = torch.where(group_alive, first_idx, _I32_MAX)
        occ_perm = torch.sort(occ_key, stable=True).indices
        occ_rank = torch.empty(n, dtype=torch.int64, device=dev).index_put(
            (occ_perm,), torch.arange(n, device=dev))
        keep_group = group_alive & (occ_rank < capacity)
    else:
        keep_group = group_alive & (torch.arange(n, device=dev) < capacity)

    out_rank = torch.cumsum(keep_group.to(torch.int64), 0) - 1
    out_rank = torch.where(keep_group, out_rank, -1)
    group_key = torch.full((n,), _I32_MAX, dtype=torch.int64,
                           device=dev).scatter_reduce(
        0, gsafe, sk.to(torch.int64), reduce="amin")

    safe_rank = torch.where(out_rank >= 0, out_rank, capacity)
    vox_keys = torch.full((capacity + 1,), KEY_SENTINEL, dtype=torch.int64,
                          device=dev).index_put(
        (safe_rank,), torch.where(keep_group, group_key, KEY_SENTINEL))
    vox_keys = vox_keys[:capacity].to(torch.int32)
    vox_counts = torch.zeros(capacity + 1, dtype=torch.int64,
                             device=dev).index_put(
        (safe_rank,), torch.where(keep_group, counts_full, 0))
    vox_counts = vox_counts[:capacity].to(torch.int32)
    vox_valid = vox_keys != KEY_SENTINEL
    vox_coords = torch.where(
        vox_valid[:, None],
        delinearize_key(torch.where(vox_valid, vox_keys, 0), dims), 0,
    )

    pt_out = torch.where(group >= 0, out_rank[gsafe], -1)
    point_to_voxel = torch.empty(n, dtype=torch.int32, device=dev).index_put(
        (perm,), pt_out.to(torch.int32))
    point_slot = torch.empty(n, dtype=torch.int32, device=dev).index_put(
        (perm,), slot_sorted.to(torch.int32))

    sites = SparseTensor(
        coords=vox_coords, keys=vox_keys,
        feats=torch.zeros((capacity, 0), dtype=torch.float32, device=dev),
        valid=vox_valid, dims=tuple(dims),
    )
    return sites, point_to_voxel, point_slot, vox_counts


def voxelize_points(points, point_valid, pc_range, voxel_size, dims,
                    capacity: int, max_points_per_voxel: int):
    """PointToVoxel + MeanVFE: mean over each voxel's first
    ``max_points_per_voxel`` points. Returns (SparseTensor, p2v (N,))."""
    dev = points.device
    inv = 1.0 / torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=dev)
    vox_coord = torch.floor((points[:, :3] - lo) * inv).to(torch.int32)
    sites, p2v, slot, counts = unique_voxels(
        vox_coord, dims, capacity, point_valid, first_occurrence_cap=True)
    M = max_points_per_voxel
    in_mean = (p2v >= 0) & (slot < M)
    # every point of the mean owns one cell (voxel, slot), and a voxel's
    # slots follow its points' order: summed slot by slot, the sum is the
    # JAX package's segment sum in point order, with no atomic adds, so
    # the same on every run (a float index_add_ on CUDA is not)
    cell = torch.where(in_mean, p2v.to(torch.int64) * M + slot, capacity * M)
    per_slot = torch.zeros(((capacity + 1) * M, points.shape[1]),
                           dtype=points.dtype, device=dev).index_put(
                               (cell,), points)
    per_slot = per_slot.view(capacity + 1, M, -1)
    feat_sum = per_slot[:, 0]
    for s in range(1, M):
        feat_sum = feat_sum + per_slot[:, s]
    denom = torch.clamp(torch.clamp(counts, max=max_points_per_voxel),
                        min=1).to(points.dtype)
    return sites.replace_feats(feat_sum[:capacity] / denom[:, None]), p2v


def devoxelize(voxel_feats, point_to_voxel):
    """Per-voxel features -> per-point; id -1 -> zeros."""
    padded = torch.cat([voxel_feats, voxel_feats.new_zeros(
        (1, voxel_feats.shape[1]))])
    idx = torch.where(point_to_voxel >= 0, point_to_voxel,
                      voxel_feats.shape[0])
    return padded[idx.to(torch.int64)]
