"""Slab engine (port of insmos_tpu/sparse/slab.py).

A ``Slab`` is a fixed-capacity T-dense sparse tensor: sites are the sorted
set of 3D voxel keys, and the temporal axis is stored dense per site
(``feats (V, T*C)`` t-major, ``occ (V, T)``). Features are zero at
non-occupied (site, t) slots. Everything here keeps the reference's static
capacities: no operation has a data-dependent output shape, so nothing
synchronises with the host.

Two engines convolve slabs. The span engine (span_conv.py, with its CUDA
kernel) carries every conv of the inference path. The windowed engine here
(``window_tables`` / ``window_conv``) is the differentiable one that
training runs: per (dy, dz) kernel-offset group it gathers each output
site's kx x-neighbours, which sit in consecutive rows of the sorted site
array, and multiplies them by the group's weight with the t-kernel folded
in. Its backward (``_ConvCore``) recomputes each group's gather instead of
saving it. ``maintain_window_slab`` keeps the fixed-frame streaming mode's
window site set from one step to the next.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch.utils import _pytree

from .tensor import KEY_SENTINEL

INT32_MAX = 2**31 - 1


@dataclass
class Slab:
    keys: torch.Tensor  # (V,) int32 sorted, sentinel padding
    coords: torch.Tensor  # (V, 3) int32 (x, y, z); 0 on padding rows
    occ: torch.Tensor  # (V, T) bool
    feats: torch.Tensor  # (V, T*C), zero at non-occupied slots
    valid: torch.Tensor  # (V,) bool
    dims: tuple
    T: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_features(self) -> int:
        return self.feats.shape[-1] // self.T

    def replace_feats(self, feats) -> "Slab":
        return Slab(self.keys, self.coords, self.occ, feats, self.valid,
                    self.dims, self.T)

    def mask_feats(self, feats=None) -> torch.Tensor:
        """Zero features at non-occupied slots: (V, T*C)."""
        f = self.feats if feats is None else feats
        C = f.shape[-1] // self.T
        m = self.occ.repeat_interleave(C, dim=1)
        return torch.where(m, f, torch.zeros((), dtype=f.dtype, device=f.device))


# a pytree (``dims`` and ``T`` static), so a vmapped function can return one
_pytree.register_pytree_node(
    Slab,
    lambda x: ((x.keys, x.coords, x.occ, x.feats, x.valid), (x.dims, x.T)),
    lambda leaves, ctx: Slab(*leaves, *ctx),
)


def linearize3(coords, dims):
    """(..., 3) int coords -> (...,) int32 key, x fastest; OOB -> sentinel."""
    c = coords.to(torch.int64)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    ok = ((x >= 0) & (x < dims[0]) & (y >= 0) & (y < dims[1])
          & (z >= 0) & (z < dims[2]))
    key = (z * dims[1] + y) * dims[0] + x
    return torch.where(ok, key, KEY_SENTINEL).to(torch.int32)


def delinearize3(keys, dims):
    k = keys.to(torch.int64)
    x = k % dims[0]
    y = (k // dims[0]) % dims[1]
    z = k // (dims[0] * dims[1])
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def _iota(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _first_of_run(sorted_vals):
    """(N,) bool: row starts a run of equal values."""
    return torch.cat([torch.ones_like(sorted_vals[:1], dtype=torch.bool),
                      sorted_vals[1:] != sorted_vals[:-1]])


def _compact_by_sort(order_key, payload, capacity: int, fill):
    """Payload rows in stable ascending order_key, cut/padded to capacity."""
    perm = torch.sort(order_key, stable=True).indices
    out = payload[perm][:capacity]
    if out.shape[0] < capacity:
        pad = torch.full((capacity - out.shape[0],) + tuple(out.shape[1:]),
                         fill, dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad])
    return out


def _sites_of_sorted(skeys, capacity: int, dims):
    """Unique sorted keys (sentinel tail) -> (site_keys, coords, valid,
    first, rank, n_sites) at a fixed capacity."""
    alive = skeys != KEY_SENTINEL
    first = _first_of_run(skeys) & alive
    rank = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_sites = torch.where(first, rank + 1, 0).max()
    site_keys = _compact_by_sort(
        torch.where(first & (rank < capacity), rank, INT32_MAX), skeys,
        capacity, KEY_SENTINEL,
    )
    live = _iota(capacity, skeys.device) < torch.clamp(n_sites, max=capacity)
    site_keys = torch.where(live, site_keys, KEY_SENTINEL)
    valid = site_keys != KEY_SENTINEL
    coords = torch.where(
        valid[:, None], delinearize3(torch.where(valid, site_keys, 0), dims), 0
    )
    return site_keys, coords, valid, first, rank, n_sites


def build_slab(coords3, tcol, point_valid, dims: Sequence[int], T: int,
               capacity: int):
    """Points -> Slab site set. Returns (slab with empty feats,
    point_to_slot (N,) int32 flat site*T + t or -1, n_sites, n_dropped)."""
    dev = coords3.device
    n = coords3.shape[0]
    key3 = linearize3(coords3, dims)
    key3 = torch.where(point_valid, key3, KEY_SENTINEL)
    # lexicographic (key, t) stable sort == lax.sort(num_keys=2)
    comb = key3.to(torch.int64) * (T + 1) + tcol.to(torch.int64)
    sperm = torch.sort(comb, stable=True).indices
    sk = key3[sperm]
    st = tcol.to(torch.int32)[sperm]

    site_keys, coords, valid, first3, rank3, n_sites = _sites_of_sorted(
        sk, capacity, dims
    )
    alive = sk != KEY_SENTINEL
    in_cap = alive & (rank3 < capacity)
    n_dropped = (alive & ~in_cap).sum()
    rank3 = torch.where(in_cap, rank3, -1)

    first4 = _first_of_run(sk) | torch.cat(
        [torch.ones(1, dtype=torch.bool, device=dev), st[1:] != st[:-1]]
    )
    first4 = first4 & in_cap
    flat4 = torch.where(first4, rank3 * T + st, capacity * T).to(torch.int64)
    occ = torch.zeros(capacity * T + 1, dtype=torch.bool, device=dev
                      ).index_put((flat4,), torch.ones((), dtype=torch.bool,
                                                      device=dev))
    occ = occ[:-1].reshape(capacity, T)

    p2slot = torch.empty(n, dtype=torch.int32, device=dev).index_put(
        (sperm,), torch.where(in_cap, rank3 * T + st, -1))

    slab = Slab(
        keys=site_keys, coords=coords, occ=occ,
        feats=torch.zeros((capacity, 0), dtype=torch.float32, device=dev),
        valid=valid, dims=tuple(dims), T=T,
    )
    return slab, p2slot, n_sites, n_dropped


def maintain_window_slab(prev_keys, prev_occ, prev_stem, nslab_keys,
                         nslab_valid, shift, dims, W: int, C: int,
                         capacity: int):
    """The fixed-frame streaming window's L1 site set, from the previous
    step's: its keys shifted by the integer-voxel translation (``shift``
    (3,) int32: previous-frame coords = new-frame coords + shift; sites
    leaving the grid are dropped), its occupancy rolled one slot (sites
    left empty are dropped) and the new scan's sorted site keys merged in
    by one stable (cap0 + scan_cap)-row sort: old rows come first in the
    concat, so they win key ties.

    Returns (site_keys, coords, occ, stem_shifted, new_pos, n_sites,
    n_dropped): stem_shifted holds the stem cache's slots 0..W-2 re-rowed
    to the new site order (slot W-1 zero: the caller writes the new scan's
    stem output at rows new_pos[i] for its slab row i, -1 = dropped)."""
    dev = prev_keys.device
    cap0 = prev_keys.shape[0]
    pc = delinearize3(torch.where(prev_keys != KEY_SENTINEL, prev_keys, 0),
                      dims)
    shifted = linearize3(pc - shift.to(torch.int32)[None, :], dims)
    occ_roll = torch.cat(
        [prev_occ[:, 1:], torch.zeros((cap0, 1), dtype=torch.bool,
                                      device=dev)], dim=1)
    keep_old = ((prev_keys != KEY_SENTINEL) & (shifted != KEY_SENTINEL)
                & occ_roll.any(dim=1))
    k_old = torch.where(keep_old, shifted, KEY_SENTINEL)
    k_new = torch.where(nslab_valid, nslab_keys, KEY_SENTINEL)

    sv, spl = torch.sort(torch.cat([k_old, k_new]), stable=True)
    site_keys, coords, valid, first, rank, n_sites = _sites_of_sorted(
        sv, capacity, dims)
    in_cap = (sv != KEY_SENTINEL) & (rank < capacity)
    n_dropped = torch.clamp(n_sites - capacity, min=0)

    # per-source destination rows: the sort's inverse permutation, by a
    # scatter (spl is a permutation, so every row is written once)
    dest = torch.empty_like(sv).index_put((spl,),
                                          torch.where(in_cap, rank, -1))
    old_pos, new_pos = dest[:cap0], dest[cap0:]

    # occupancy and the rolled stem cache, re-rowed by scatter onto unique
    # rows; everything dropped lands on the extra row ``capacity``
    safe_old = torch.where(keep_old & (old_pos >= 0), old_pos,
                           capacity).to(torch.int64)
    occ_old = torch.zeros((capacity + 1, W - 1), dtype=torch.bool,
                          device=dev).index_put((safe_old,),
                                                occ_roll[:, :W - 1])
    new_rows = torch.where(nslab_valid & (new_pos >= 0), new_pos,
                           capacity).to(torch.int64)
    occ_new = torch.zeros(capacity + 1, dtype=torch.bool, device=dev
                          ).index_put((new_rows,), torch.ones(
                              (), dtype=torch.bool, device=dev))
    occ = torch.cat([occ_old, occ_new[:, None]], dim=1)
    stem_rolled = torch.cat([prev_stem[:, C:], prev_stem.new_zeros((cap0, C))],
                            dim=1)
    stem_shifted = torch.zeros((capacity + 1, W * C), dtype=prev_stem.dtype,
                               device=dev).index_put((safe_old,), stem_rolled)
    return (site_keys, coords, occ[:capacity], stem_shifted[:capacity],
            new_pos, n_sites, n_dropped)


def slab_from_sparse(x) -> Slab:
    """SparseTensor (3D) -> Slab with T=1."""
    return Slab(x.keys, x.coords, x.valid[:, None], x.feats, x.valid,
                tuple(x.dims), 1)


def sparse_from_slab(x: Slab):
    """T=1 Slab -> SparseTensor."""
    from .tensor import SparseTensor

    assert x.T == 1
    return SparseTensor(x.coords, x.keys, x.feats, x.valid, tuple(x.dims))


def _strided_candidates(coords, valid, kernel3, stride3, pad3):
    """Per input site, the <= prod(ceil(k/s)) output sites it feeds.
    Returns (cands (V, Kc, 3) int32, ok (V, Kc) bool)."""
    dev = coords.device
    per_dim = [int(math.ceil(k / s)) for k, s in zip(kernel3, stride3)]
    rng = [torch.arange(c, dtype=torch.int32, device=dev) for c in per_dim]
    mesh = torch.meshgrid(*rng[::-1], indexing="ij")
    cand = torch.stack([m.reshape(-1) for m in mesh[::-1]], dim=-1)  # (Kc, 3)
    s = torch.tensor(stride3, dtype=torch.int32, device=dev)
    p = torch.tensor(pad3, dtype=torch.int32, device=dev)
    k = torch.tensor(kernel3, dtype=torch.int32, device=dev)
    i = coords
    o_hi = torch.div(i + p, s, rounding_mode="floor")
    cands = o_hi[:, None, :] - cand[None]
    lo_ok = cands * s - p <= i[:, None, :]
    hi_ok = cands * s - p + (k - 1) >= i[:, None, :]
    ok = (lo_ok & hi_ok & (cands >= 0)).all(-1) & valid[:, None]
    return cands, ok


def derive_strided_sites(x: Slab, kernel3, stride3, pad3, out_dims,
                         capacity: int):
    """Output site set of a strided conv: every output site receiving >= 1
    kernel contribution, deduplicated, sorted. Returns (Slab with empty
    feats and zero occ, n_sites, n_dropped_sites)."""
    cands, ok = _strided_candidates(x.coords, x.valid, kernel3, stride3, pad3)
    keys = linearize3(cands.reshape(-1, 3), out_dims)
    keys = torch.where(ok.reshape(-1), keys, KEY_SENTINEL)
    skeys = torch.sort(keys).values
    site_keys, coords, valid, _, _, n_sites = _sites_of_sorted(
        skeys, capacity, out_dims
    )
    n_dropped = torch.clamp(n_sites - capacity, min=0)
    dev = x.keys.device
    out = Slab(
        keys=site_keys, coords=coords,
        occ=torch.zeros((capacity, x.T), dtype=torch.bool, device=dev),
        feats=torch.zeros((capacity, 0), dtype=torch.float32, device=dev),
        valid=valid, dims=tuple(out_dims), T=x.T,
    )
    return out, n_sites, n_dropped


def dilate_mask(src_keys, src_sel, dims, reach: int, q_keys, q_valid):
    """For each query site: within L-inf distance ``reach`` of a selected
    source site? Dense bool grid + separable OR of shifted copies (the
    Chebyshev ball is an axis product)."""
    X, Y, Z = dims
    n = X * Y * Z
    sk = torch.where(src_sel, src_keys, n).to(torch.int64)
    grid = torch.zeros(n + 1, dtype=torch.bool, device=src_keys.device
                       ).index_put((sk.clamp(max=n),), torch.ones(
                           (), dtype=torch.bool, device=src_keys.device))
    g = grid[:n].reshape(Z, Y, X)
    for ax in (2, 1, 0):
        out = g.clone()
        L = g.shape[ax]
        for s in range(1, reach + 1):
            if s >= L:
                break
            out.narrow(ax, s, L - s).logical_or_(g.narrow(ax, 0, L - s))
            out.narrow(ax, 0, L - s).logical_or_(g.narrow(ax, s, L - s))
        g = out
    m = g.reshape(-1)[q_keys.to(torch.int64).clamp(0, n - 1)]
    return m & q_valid


def compact_rows(sel, capacity: int):
    """Selected-row indices compacted to ``capacity`` (order-preserving).
    Returns ((capacity,) int32 row or -1, overflow count)."""
    pos = torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = sel & (pos < capacity)
    tgt = torch.where(keep, pos, capacity).to(torch.int64)
    # kept rows land on unique slots; the rest all write -1 to the dump slot
    idx = torch.full((capacity + 1,), -1, dtype=torch.int32, device=sel.device
                     ).index_put((tgt,), torch.where(
                         keep, _iota(sel.shape[0], sel.device), -1))
    n = sel.sum()
    return idx[:capacity], torch.clamp(n - capacity, min=0)


def take_rows(a, idx, fill=0):
    """Row gather with -1 -> fill."""
    rows = a[idx.clamp(min=0).to(torch.int64)]
    m = (idx >= 0).reshape((-1,) + (1,) * (a.ndim - 1))
    return torch.where(m, rows, torch.tensor(fill, dtype=a.dtype,
                                             device=a.device))


def site_grid(x: Slab) -> torch.Tensor:
    """Dense (X*Y*Z + 2,) int32 map: key -> site index or -1."""
    n_cells = math.prod(x.dims)
    safe = torch.where(x.valid, x.keys, n_cells + 2).to(torch.int64)
    grid = torch.full((n_cells + 3,), -1, dtype=torch.int32,
                      device=x.keys.device).index_put(
                          (safe,), _iota(x.capacity, x.keys.device))
    return grid[: n_cells + 2]


def _groups_yz(kernel3):
    """Non-x kernel offset groups (ky, kz), y fastest (weight axis order)."""
    return [(ky, kz) for kz in range(kernel3[2]) for ky in range(kernel3[1])]


@dataclass
class WindowTables:
    """Per-(site set, kernel geometry) neighbour tables of the windowed
    engine.

    wstart:  (G, V) int32: row of the first present x-window neighbour of
             group g (``vin``, the zero row, when none is present).
    slotmap: (G, kx, V) int8: window slot holding kernel x-position j
             (its rank among the present neighbours), or -1 when absent.
    """

    wstart: torch.Tensor
    slotmap: torch.Tensor
    kx: int
    vin: int

    def conv(self, x: Slab, weight, out: Slab, kernel, chunk=None,
             t0_off: int = 0) -> Slab:
        """The conv entry shared with span_conv.SpanPlan."""
        return window_conv(x, weight, self, out, kernel, chunk=chunk,
                           t0_off=t0_off)


def window_tables(grid, in_dims, out_coords, out_valid, kernel3,
                  stride3=(1, 1, 1), pad3=None, vin: int = 0) -> WindowTables:
    """wstart/slotmap of a (possibly strided) conv. The input that output o
    needs at kernel x-position j is at x = ox*sx - px + j: consecutive in
    j, so its present neighbours occupy consecutive rows of the sorted
    site array. ``grid`` is site_grid of the input slab, indexed directly
    (the reference probes it through an overlapped 256-wide view, a TPU
    layout; the integers are the same)."""
    kx = int(kernel3[0])
    if pad3 is None:  # centered submanifold
        pad3 = tuple((k - 1) // 2 for k in kernel3)
    X, Y, Z = in_dims
    dev = out_coords.device
    oc = out_coords.to(torch.int64)
    ox = oc[:, 0] * stride3[0] - pad3[0]
    oy0 = oc[:, 1] * stride3[1] - pad3[1]
    oz0 = oc[:, 2] * stride3[2] - pad3[2]
    jx = torch.arange(kx, device=dev)
    xs = ox[:, None] + jx[None]
    x_ok = (xs >= 0) & (xs < X)
    last = grid.shape[0] - 1
    wstarts, slotmaps = [], []
    for ky_i, kz_i in _groups_yz(kernel3):
        iy, iz = oy0 + ky_i, oz0 + kz_i
        row_ok = out_valid & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
        cells = ((iz * Y + iy) * X)[:, None] + xs
        idx = grid[cells.clamp(0, last)]
        present = x_ok & row_ok[:, None] & (idx >= 0)
        rank = torch.cumsum(present.to(torch.int32), dim=1) - 1
        slot = torch.where(present, rank, -1).to(torch.int8)
        start = torch.where(present, idx, INT32_MAX).amin(dim=1)
        wstarts.append(torch.where(start == INT32_MAX, vin, start).to(
            torch.int32))
        slotmaps.append(slot.T)
    return WindowTables(wstart=torch.stack(wstarts),
                        slotmap=torch.stack(slotmaps), kx=kx, vin=vin)


def slice_slots(x: Slab, t0: int, T_eff: int) -> Slab:
    """Slots [t0, t0 + T_eff) of a slab (t-pruned inference)."""
    C = x.num_features
    return Slab(
        x.keys, x.coords, x.occ[:, t0:t0 + T_eff],
        x.feats[:, t0 * C:(t0 + T_eff) * C] if x.feats.shape[-1] else x.feats,
        x.valid, x.dims, T_eff,
    )


def t_band(kt: int, T_in: int, T_out: int, doff: int, dtype=torch.float32,
           device=None):
    """(kt, T_in, T_out) band selectors: output slot p reads input slot
    i = p + doff + it - lo; entries outside [0, T_in) vanish."""
    lo = (kt - 1) // 2
    i = torch.arange(T_in, device=device)[:, None]
    p = torch.arange(T_out, device=device)[None, :]
    return torch.stack(
        [(i == p + doff + it - lo).to(dtype) for it in range(kt)]
    )


def _window_rows(wstart_g, slotmap_g, vin: int):
    """(rows, kx) int64 input row of each kernel x-position of one group:
    wstart + slot, or the zero row ``vin`` where the neighbour is absent."""
    sm = slotmap_g.T.to(torch.int64)
    return torch.where(sm >= 0, wstart_g.to(torch.int64)[:, None] + sm, vin)


def _row_chunks(V: int, chunk):
    if chunk is None or V <= chunk:
        return [(0, V)]
    assert V % chunk == 0, f"capacity {V} % chunk {chunk}"
    return [(a, a + chunk) for a in range(0, V, chunk)]


class _ConvCore(torch.autograd.Function):
    """sum_g gather(feats, g) @ wg[g], float32 accumulation, with a
    memory-bounded backward: only (feats, wg, tables) are saved, each
    group's gather is recomputed in the backward, dW and the feature
    cotangent are computed in float32 and the latter is scatter-added back
    through the window rows (the reference's _conv_core custom VJP). Output
    rows are processed ``chunk`` at a time in both directions."""

    @staticmethod
    def forward(ctx, feats, wg, wstart, slotmap, chunk):
        Vin, TC = feats.shape
        G, V = wstart.shape
        fpad = torch.cat([feats, feats.new_zeros((1, TC))])
        w32 = wg.float()
        out = torch.zeros((V, wg.shape[2]), dtype=torch.float32,
                          device=feats.device)
        for a, b in _row_chunks(V, chunk):
            acc = out[a:b]
            for g in range(G):
                rows = _window_rows(wstart[g, a:b], slotmap[g, :, a:b], Vin)
                src = fpad[rows.reshape(-1)].reshape(b - a, -1).float()
                acc += src @ w32[g]
        ctx.save_for_backward(feats, wg, wstart, slotmap)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, grad):
        feats, wg, wstart, slotmap = ctx.saved_tensors
        Vin, TC = feats.shape
        G, V = wstart.shape
        kx = slotmap.shape[1]
        fpad = torch.cat([feats, feats.new_zeros((1, TC))])
        g32 = grad.float()
        w32 = wg.float()
        dfp = torch.zeros((Vin + 1, TC), dtype=torch.float32,
                          device=feats.device)
        dw = torch.zeros(w32.shape, dtype=torch.float32, device=feats.device)
        for a, b in _row_chunks(V, ctx.chunk):
            for g in range(G):
                rows = _window_rows(wstart[g, a:b], slotmap[g, :, a:b],
                                    Vin).reshape(-1)
                src = fpad[rows].reshape(b - a, kx * TC).float()
                dw[g] += src.T @ g32[a:b]
                dsrc = g32[a:b] @ w32[g].T
                dfp.index_add_(0, rows, dsrc.reshape(-1, TC))
        return (dfp[:Vin].to(feats.dtype), dw.to(wg.dtype), None, None,
                None)


def window_conv(x: Slab, weight, tables: WindowTables, out: Slab, kernel,
                chunk=None, t0_off: int = 0) -> Slab:
    """Windowed sparse conv: submanifold (``out`` is x, centered tables) or
    strided (``out`` from derive_strided_sites, tables with stride/pad).
    ``weight`` (K, cin, cout), K enumerated x-fastest and t-slowest; the
    t-kernel is folded into each group's flat weight as a (T, T_out) band
    (block-diagonal over t), so a 3^4 kernel costs one matmul per group.
    ``t0_off`` offsets out's slot range against x's (t-pruned inference).
    Features enter in the weight's dtype; products and sums are float32."""
    kx = tables.kx
    kt = kernel[3] if len(kernel) == 4 else 1
    G = tables.wstart.shape[0]
    K, cin, cout = weight.shape
    assert K == kx * G * kt, (K, kx, G, kt)
    T, Tout = x.T, out.T
    w5 = weight.reshape(kt, G, kx, cin, cout)
    bands = t_band(kt, T, Tout, t0_off, torch.float32, weight.device)
    wg = torch.einsum("igdco,itp->gdtcpo", w5.float(), bands).reshape(
        G, kx * T * cin, Tout * cout).to(weight.dtype)
    feats = _ConvCore.apply(x.mask_feats().to(weight.dtype), wg,
                            tables.wstart, tables.slotmap, chunk)
    res = out.replace_feats(feats)
    return res.replace_feats(res.mask_feats())


def strided_occ(x: Slab, tables: WindowTables, out: Slab) -> Slab:
    """out.occ = OR of the occupancy of the children each output site
    gathers (the 4D site set of a t-kernel-1 strided conv: same-t
    children): window slot w of group g holds the w-th present neighbour,
    so slots below the group's present count are the children."""
    kx = tables.kx
    occ_pad = torch.cat([x.occ & x.valid[:, None],
                         x.occ.new_zeros((1, x.T))])
    acc = torch.zeros((out.capacity, x.T), dtype=torch.bool,
                      device=x.keys.device)
    wst = tables.wstart.to(torch.int64)
    for g in range(wst.shape[0]):
        count = (tables.slotmap[g] >= 0).sum(dim=0)
        for w in range(kx):
            rows = torch.where(w < count, wst[g] + w, x.capacity)
            acc |= occ_pad[rows]
    occ = acc & out.valid[:, None]
    return Slab(out.keys, out.coords, occ, out.feats, out.valid, out.dims,
                out.T)


def inverse_s2k2_conv(coarse: Slab, weight, fine: Slab, parent_idx) -> Slab:
    """Inverse of the stride-2 kernel-2 down conv: each fine site has one
    coarse parent and one kernel position (f & 1 per dim)."""
    K, cin, cout = weight.shape
    T = coarse.T
    f = coarse.mask_feats().to(weight.dtype)
    idx = torch.where(parent_idx >= 0, parent_idx, coarse.capacity)
    f_pad = torch.cat([f, f.new_zeros((1, T * cin))])
    pf = f_pad[idx.to(torch.int64)]  # (Vf, T*cin)
    kidx = ((fine.coords[:, 0] & 1) + 2 * (fine.coords[:, 1] & 1)
            + 4 * (fine.coords[:, 2] & 1))
    eyeT = torch.eye(T, dtype=torch.float32, device=weight.device)
    w_all = torch.einsum("kcd,tp->ktcpd", weight[:8].float(), eyeT).reshape(
        8, T * cin, T * cout
    )
    TOUT = T * cout
    out = torch.zeros((fine.capacity, TOUT), dtype=torch.float32,
                      device=weight.device)
    pf32 = pf.float()
    for k in range(8):
        sel = kidx == k
        out = torch.where(sel[:, None], pf32 @ w_all[k], out)
    res = fine.replace_feats(out)
    return res.replace_feats(res.mask_feats())


def parent_index(grid_coarse, coarse_dims, fine: Slab) -> torch.Tensor:
    """(Vf,) index of each fine site's stride-2 parent in the coarse slab."""
    key = linearize3(torch.div(fine.coords, 2, rounding_mode="floor"),
                     coarse_dims)
    n_cells = math.prod(coarse_dims)
    probe = torch.where(fine.valid & (key != KEY_SENTINEL), key, n_cells + 1)
    return grid_coarse[probe.to(torch.int64)]


def gather_slots(slab: Slab, point_to_slot, C: int):
    """Per-point features from a slab: slot = site*T + t; -1 -> zeros."""
    T = slab.T
    f_pad = torch.cat([slab.feats, slab.feats.new_zeros((1, T * C))])
    site = torch.where(point_to_slot >= 0,
                       torch.div(point_to_slot, T, rounding_mode="floor"),
                       slab.capacity)
    t = torch.where(point_to_slot >= 0, point_to_slot % T, 0)
    rows = f_pad[site.to(torch.int64)]
    cols = t[:, None].to(torch.int64) * C + torch.arange(
        C, device=rows.device)[None]
    return torch.gather(rows, 1, cols)
