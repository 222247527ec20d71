"""MotionNet: the 4D (x, y, z, t) sparse UNet over the scan window (port of
insmos_tpu/nn/minkunet4d.py).

Structure (channels; kernels as (spatial, temporal)):
  stem    subm (5,1)            in -> 8
  down1   strided (2,1) s(2,1)   8 -> 8   + block1 BasicBlock(8 -> 8, 3^4)
  down2   strided (2,1) s(2,1)   8 -> 8   + block2 BasicBlock(8 -> 16)
  down3   strided (2,1) s(2,1)  16 -> 16  + block3 BasicBlock(16 -> 32)
  up5     inverse (2,1)         32 -> 32  ; cat block2 -> 48; block6 -> 32
  up6     inverse (2,1)         32 -> 16  ; cat block1 -> 24; block7 -> 16
  up7     inverse (2,1)         16 -> 8   ; cat stem   -> 16; block8 -> 8
  final   1x1 conv (bias)        8 -> out (3 motion classes)

Two engines (``use_span_engine``): inference runs on the span engine with
the t-pruning schedule (only the current scan's output is consumed, so each
tensor keeps a trailing slot window) and the decoder's spatial pruning onto
reach-2 halos of the current scan; training runs on the differentiable
windowed engine (slab.window_tables / window_conv) over the whole window,
its BatchNorm statistics over every occupied 4D site. The stem runs over
the whole window every step (ref-exact mode) or, in the fixed-frame
incremental mode, only over the new scan at T=1: the stem's t-kernel is 1,
so a slot's output depends on its own scan alone and the previous step's
outputs (the stem cache) are reused, shifted one slot. Plan budgets are the
reference's literal values (PLAN_BUDGETS); the plans diverge otherwise.
"""

from __future__ import annotations

import torch
from torch import nn

from ..sparse.slab import (
    Slab,
    build_slab,
    compact_rows,
    derive_strided_sites,
    dilate_mask,
    gather_slots,
    linearize3,
    maintain_window_slab,
    parent_index,
    site_grid,
    slice_slots,
    strided_occ,
    take_rows,
    window_tables,
)
from ..sparse.span_conv import _bisect, make_span_plan, make_span_plans
from ..sparse.tensor import KEY_SENTINEL
from .blocks_slab import (
    BasicBlock,
    ConvBN,
    basic_block_slab_cat,
    basic_block_slab_pruned,
    cat_slab,
    inverse_block_slab,
    subm_block_slab,
)
from .layers import Linear, cast_compute, mm

_K_STEM = (5, 5, 5, 1)
_K_DOWN = (2, 2, 2, 1)
_K_BLOCK = (3, 3, 3, 3)
_K3_STEM = (5, 5, 5)
_K3_DOWN = (2, 2, 2)
_K3_BLOCK = (3, 3, 3)
_S2 = (2, 2, 2)
_P0 = (0, 0, 0)

# Plan budgets: the reference's literal values (minkunet4d.py:366-403,
# 433-436, 488-495), keyed by plan and level factor.
PLAN_BUDGETS = {
    "block": {1: dict(span=192, slots=3200, gwin=64, pairs=3072),
              2: dict(span=192, slots=1536, gwin=32, pairs=1024),
              4: dict(span=192, slots=512, gwin=24, pairs=512),
              8: dict(span=384, slots=128, gwin=8)},
    "down": {2: dict(span=256, slots=1024, gwin=24, pairs=2048),
             4: dict(span=256, slots=512, gwin=24, pairs=1024),
             8: dict(span=256, slots=384, gwin=24, pairs=512)},
    "stem": dict(span=256, slots=12288, gwin=64, pairs=4096),
    # the incremental mode's T=1 stem plan over the new scan's own slab
    # (minkunet4d.py:147-150)
    "stem_scan": dict(span=192, slots=3072, gwin=40, pairs=2560),
    "dec": {1: dict(span=192, slots=2304, gwin=48, pairs=2048),
            2: dict(span=192, slots=1024, gwin=32, pairs=768),
            4: dict(span=192, slots=512, gwin=40, pairs=384)},
}


# MinkowskiEngine BatchNorm defaults (minkunet4d._bn_of): eps, and the
# momentum that cfg.train.bn_momentum_scale scales
_EPS = 1e-5
_MOMENTUM = 0.1


def use_span_engine(cfg, train: bool) -> bool:
    """The span engine for inference, the windowed engine for training, on
    either device; ``sparse_engine`` "window" or "span" forces one. (The
    reference's "auto" also takes the windowed engine for inference on the
    CPU; the port's CPU inference is the span engine's plain route, held
    against the reference's window engine by the tests.)"""
    mode = cfg.runtime.sparse_engine
    if mode == "window":
        return False
    if mode == "span":
        return True
    return not train


class MotionNet(nn.Module):
    """Parameters of MotionNet, named as the JAX tree (init_motionnet)."""

    def __init__(self, cfg):
        super().__init__()
        mc = cfg.model.motionnet
        pl, d0 = mc.planes, mc.init_dim
        bn = (_EPS, _MOMENTUM)
        kv = lambda k: k[0] * k[1] * k[2] * k[3]  # noqa: E731
        self.stem = ConvBN(kv(_K_STEM), 1, d0, *bn)
        self.down1 = ConvBN(kv(_K_DOWN), d0, d0, *bn)
        self.block1 = BasicBlock(kv(_K_BLOCK), d0, pl[0], d0 != pl[0], *bn)
        self.down2 = ConvBN(kv(_K_DOWN), pl[0], pl[0], *bn)
        self.block2 = BasicBlock(kv(_K_BLOCK), pl[0], pl[1], True, *bn)
        self.down3 = ConvBN(kv(_K_DOWN), pl[1], pl[1], *bn)
        self.block3 = BasicBlock(kv(_K_BLOCK), pl[1], pl[2], True, *bn)
        self.up5 = ConvBN(kv(_K_DOWN), pl[2], pl[5], *bn)
        self.block6 = BasicBlock(kv(_K_BLOCK), pl[5] + pl[1], pl[5], True, *bn)
        self.up6 = ConvBN(kv(_K_DOWN), pl[5], pl[6], *bn)
        self.block7 = BasicBlock(kv(_K_BLOCK), pl[6] + pl[0], pl[6], True, *bn)
        self.up7 = ConvBN(kv(_K_DOWN), pl[6], pl[7], *bn)
        self.block8 = BasicBlock(kv(_K_BLOCK), pl[7] + d0, pl[7], True, *bn)
        self.final = Linear(pl[7], mc.out_channels, bias=True)


def _level_dims(dims3, factor):
    return tuple(-(-d // factor) for d in dims3)


def _run_fresh_stem(p: MotionNet, cfg, c3_new, pv_new, dims1, stats, dtype):
    """The stem over the NEW scan's own slab at T=1, whose site capacity
    is ``stem_scan_capacity`` (a scan's voxels, not its points). Appends
    the slab's point drops to stats["dropped"] and its plan's coverage
    counter to stats["span_overflow"]. Returns (scan slab, point -> scan
    site row or -1, the stem output on the scan slab)."""
    scan_cap = cfg.model.motionnet.stem_scan_capacity
    tcol = torch.zeros(c3_new.shape[:1], dtype=torch.int32,
                       device=c3_new.device)
    nslab, p2s, _, n_drop = build_slab(c3_new, tcol, pv_new, dims1, 1,
                                       scan_cap)
    stats["dropped"].append(n_drop)
    nslab = nslab.replace_feats(0.5 * nslab.occ.to(torch.float32))
    ntbl = make_span_plan(nslab.keys, nslab.coords, nslab.valid, _K3_STEM,
                          in_dims=dims1, **PLAN_BUDGETS["stem_scan"])
    stats["span_overflow"].append(ntbl.n_overflow)
    fresh = subm_block_slab(p.stem, nslab, _K_STEM, ntbl, dtype=dtype)
    return nslab, p2s, fresh


def _incremental_stem(p: MotionNet, cfg, x: Slab, coords3, point_valid,
                      dims1, stem_cache, stats, dtype, cache_shift=None):
    """The stem output on a window slab built from the points: the previous
    step's cached slots, key-matched onto this window's sites and shifted
    one slot, plus the new scan's T=1 stem pass in slot W-1. ``cache_shift``
    ((3,) int32) is the step's integer-voxel translation: a site at coords c
    was at c + cache_shift in the previous frame; sites whose previous
    coords leave the grid miss and get zero history."""
    W, P = point_valid.shape
    cap0 = x.capacity
    C = p.stem.conv.w.shape[-1]
    nslab, _, fresh = _run_fresh_stem(
        p, cfg, coords3.reshape(W, P, 3)[W - 1], point_valid[W - 1], dims1,
        stats, dtype)
    scan_cap = cfg.model.motionnet.stem_scan_capacity

    if cache_shift is None:
        qkeys = x.keys
    else:
        qkeys = linearize3(x.coords + cache_shift.to(torch.int32)[None, :],
                           dims1)
        qkeys = torch.where(x.valid, qkeys, KEY_SENTINEL)
    ckeys = stem_cache["keys"]
    pos = _bisect(ckeys, qkeys).clamp(0, cap0 - 1).long()
    hit = (ckeys[pos] == qkeys) & x.valid & (qkeys != KEY_SENTINEL)
    rows = stem_cache["feats"][pos]
    rows = torch.where(hit[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device))
    fpos = _bisect(nslab.keys, x.keys).clamp(0, scan_cap - 1).long()
    fhit = (nslab.keys[fpos] == x.keys) & x.valid
    fr = fresh.feats[fpos].to(rows.dtype)
    merged = torch.cat([rows[:, C:], torch.where(fhit[:, None], fr, 0.0)],
                       dim=1)
    out = x.replace_feats(merged)
    return out.replace_feats(out.mask_feats())


def motionnet_forward(p: MotionNet, cfg, points, point_valid, *,
                      train: bool = False, stem_cache=None, cache_shift=None,
                      win_cache=None, emit_cache: bool = False):
    """points (W, P, 4+) pose-aligned window, point_valid (W, P).

    Returns (motion feats of the CURRENT scan (P, C) float32, stats with
    "sites", "dropped" and "span_overflow" lists of 0-d tensors; the last
    is empty on the windowed engine). ``train`` runs BatchNorm in train
    mode (each BatchNorm records its update) and no pruning.

    ``stem_cache`` ({"keys": (cap0,), "feats": (cap0, W*C)}, the previous
    step's) selects the fixed-frame incremental stem; with ``win_cache``
    ({"keys": (cap0,), "occ": (cap0, W)}) too, the L1 window site set is
    maintained from the previous step's (maintain_window_slab) instead of
    built from the window's points. ``cache_shift`` is the step's
    integer-voxel translation. Then, and with ``emit_cache``, stats also
    carries this step's "stem_cache" and "win" for the next step."""
    mc = cfg.model.motionnet
    dtype = cfg.runtime.compute_dtype
    W, P = points.shape[:2]
    dims1 = mc.grid_size
    caps = mc.site_capacities
    dev = points.device
    stats = {"sites": [], "dropped": [], "span_overflow": []}
    span = use_span_engine(cfg, train)
    prune = not train
    # the windowed engine bounds its memory by output-row chunks
    chunk = None if span else cfg.runtime.conv_chunk
    assert stem_cache is None or (span and prune), \
        "the incremental stem is an inference path of the span engine"

    lo = torch.tensor(mc.crop_range[:3], dtype=points.dtype, device=dev)
    # the maintained window site set: the previous step's, shifted, rolled
    # one slot and merged with the new scan's sites (slab.maintain_window_
    # slab); the current points reach their rows through the scan slab
    maintained = stem_cache is not None and win_cache is not None
    if maintained:
        C0 = p.stem.conv.w.shape[-1]
        c3_new = torch.floor((points[W - 1, :, :3] - lo) * 10.0).to(
            torch.int32)
        nslab, p2s_scan, fresh_stem = _run_fresh_stem(
            p, cfg, c3_new, point_valid[W - 1], dims1, stats, dtype)
        shift = (cache_shift if cache_shift is not None
                 else torch.zeros(3, dtype=torch.int32, device=dev))
        keys1, coords1, occ1, stem_shifted, new_pos, n1, drop1 = (
            maintain_window_slab(win_cache["keys"], win_cache["occ"],
                                 stem_cache["feats"], nslab.keys,
                                 nslab.valid, shift, dims1, W, C0, caps[0]))
        slab1 = Slab(keys1, coords1, occ1,
                     torch.zeros((caps[0], 0), dtype=torch.float32,
                                 device=dev),
                     keys1 != KEY_SENTINEL, dims1, W)
        p2slot = None
    else:
        xyz = points[..., :3].reshape(W * P, 3)
        coords3 = torch.floor((xyz - lo) * 10.0).to(torch.int32)  # 0.1 m
        tcol = torch.arange(W, dtype=torch.int32, device=dev)[:, None].expand(
            W, P).reshape(W * P)
        slab1, p2slot, n1, drop1 = build_slab(
            coords3, tcol, point_valid.reshape(W * P), dims1, W, caps[0]
        )
    stats["sites"].append(n1)
    stats["dropped"].append(drop1)
    x = slab1.replace_feats(0.5 * slab1.occ.to(torch.float32))

    # ---- per-level site derivation, span plans or window tables -------
    prune_dec = bool(prune and span and W > 1 and mc.decoder_prune)
    slabs = {1: x}
    tables, down_tables, parent_idx = {}, {}, {}
    dims = {1: dims1}
    B = PLAN_BUDGETS
    for fin, fout, cap in ((1, 2, caps[1]), (2, 4, caps[2]), (4, 8, caps[3])):
        dims[fout] = _level_dims(dims1, fout)
        s_in = slabs[fin]
        nxt, n_s, n_d = derive_strided_sites(s_in, _K3_DOWN, _S2, _P0,
                                             dims[fout], cap)
        stats["sites"].append(n_s)
        stats["dropped"].append(n_d)
        if not span:
            grid = site_grid(s_in)
            if fin == 1:
                tables["stem"] = window_tables(grid, dims[fin], s_in.coords,
                                               s_in.valid, _K3_STEM,
                                               vin=caps[0])
            tables[fin] = window_tables(grid, dims[fin], s_in.coords,
                                        s_in.valid, _K3_BLOCK,
                                        vin=s_in.capacity)
            down_tables[fout] = window_tables(
                grid, dims[fin], nxt.coords, nxt.valid, _K3_DOWN,
                stride3=_S2, pad3=_P0, vin=s_in.capacity)
            slabs[fout] = strided_occ(s_in, down_tables[fout], nxt)
            continue
        reqs = []
        # the L1 block plan's only consumer is block8, which decoder
        # pruning moves onto the pruned-set plan
        if fin != 1 or not prune_dec:
            reqs.append(dict(out_coords=s_in.coords, out_valid=s_in.valid,
                             kernel3=_K3_BLOCK, in_dims=dims[fin], bs=128,
                             **B["block"][fin]))
        reqs.append(dict(out_coords=nxt.coords, out_valid=nxt.valid,
                         kernel3=_K3_DOWN, stride3=_S2, pad3=_P0,
                         in_dims=dims[fin], bs=128, **B["down"][fout]))
        if fin == 1 and stem_cache is None:
            reqs.append(dict(out_coords=s_in.coords, out_valid=s_in.valid,
                             kernel3=_K3_STEM, in_dims=dims[fin],
                             **B["stem"]))
        plans = make_span_plans(s_in.keys, reqs)
        pi = 0
        if fin != 1 or not prune_dec:
            tables[fin] = plans[pi]
            pi += 1
        down_tables[fout] = plans[pi]
        pi += 1
        if len(plans) > pi:
            tables["stem"] = plans[pi]
        slabs[fout] = nxt
    s8 = slabs[8]
    grid8 = site_grid(s8)
    tables[8] = (make_span_plan(s8.keys, s8.coords, s8.valid, _K3_BLOCK,
                                in_dims=dims[8], bs=128, **B["block"][8])
                 if span else
                 window_tables(grid8, dims[8], s8.coords, s8.valid,
                               _K3_BLOCK, vin=s8.capacity))

    # ---- decoder spatial pruning: halo site subsets + plans ----------
    dec_tbl, dec_tpl, dec_idx = {}, {}, {}
    if prune_dec:
        dcaps = [min(c, s) for c, s in zip(mc.decoder_capacities, caps[:3])]

        def _sel_level(slab_l, src_keys, src_sel, dimsL, cap):
            m = dilate_mask(src_keys, src_sel, dimsL, 2, slab_l.keys,
                            slab_l.valid)
            idx, nov = compact_rows(m, cap)
            keys = torch.where(idx >= 0, slab_l.keys[idx.clamp(min=0).long()],
                               KEY_SENTINEL)
            tpl = Slab(
                keys, take_rows(slab_l.coords, idx),
                torch.zeros((cap, slab_l.T), dtype=torch.bool, device=dev),
                torch.zeros((cap, 0), dtype=torch.float32, device=dev),
                idx >= 0, slab_l.dims, slab_l.T,
            )
            return tpl, idx, nov

        s1 = slabs[1]
        dec_tpl[1], dec_idx[1], nov1 = _sel_level(
            s1, s1.keys, s1.occ[:, W - 1] & s1.valid, dims[1], dcaps[0])
        pk2 = linearize3(torch.div(dec_tpl[1].coords, 2, rounding_mode="floor"),
                         dims[2])
        dec_tpl[2], dec_idx[2], nov2 = _sel_level(
            slabs[2], pk2, dec_tpl[1].valid, dims[2], dcaps[1])
        pk4 = linearize3(torch.div(dec_tpl[2].coords, 2, rounding_mode="floor"),
                         dims[4])
        dec_tpl[4], dec_idx[4], nov4 = _sel_level(
            slabs[4], pk4, dec_tpl[2].valid, dims[4], dcaps[2])
        stats["dropped"] += [nov1, nov2, nov4]
        for lvl in (1, 2, 4):
            t = dec_tpl[lvl]
            dec_tbl[lvl] = make_span_plan(t.keys, t.coords, t.valid,
                                          _K3_BLOCK, in_dims=dims[lvl],
                                          bs=128, **B["dec"][lvl])
    # the incremental stem's scan plan (maintained) came first; the
    # un-maintained variant appends it last, at the stem below
    stats["span_overflow"] += [
        t.n_overflow for t in ([tables["stem"]] if stem_cache is None else [])
        + [
            dec_tbl[1] if prune_dec else tables[1],
            tables[2], tables[4], tables[8],
            down_tables[2], down_tables[4], down_tables[8],
        ] + ([dec_tbl[2], dec_tbl[4]] if prune_dec else [])
    ] if span else []
    for fin, fout in ((4, 8), (2, 4), (1, 2)):
        if prune_dec:
            grid = grid8 if fout == 8 else site_grid(dec_tpl[fout])
            parent_idx[fin] = parent_index(grid, dims[fout], dec_tpl[fin])
        else:
            grid = grid8 if fout == 8 else site_grid(slabs[fout])
            parent_idx[fin] = parent_index(grid, dims[fout], slabs[fin])

    # ---- t-pruning schedule: first needed slot per tensor, anchored to
    # the window end (every 3^4 conv consumes one earlier slot)
    tl = {
        "b2o": W - 9, "b3m": W - 8, "b3o": W - 7, "b6m": W - 6,
        "b6o": W - 5, "b7m": W - 4, "b7o": W - 3, "b8m": W - 2,
        "b8o": W - 1,
    } if prune and W > 1 else {}

    def t0_of(name):
        return max(tl.get(name, 0), 0)

    def sl(slab_full, t0):
        return slice_slots(slab_full, t0, W - t0) if t0 else slab_full

    def resl(tensor, t0_cur, t0_new):
        assert t0_new >= t0_cur
        return (slice_slots(tensor, t0_new - t0_cur, W - t0_new)
                if t0_new > t0_cur else tensor)

    def block_cat(name, a, b, t0_in, tbl, mid_name, out_name):
        """Residual block over cat(a, b): channel-split weights on the span
        engine, the interleaved cat on the windowed one."""
        if not span:
            return block(name, cat_slab(a, b), t0_in, tbl, mid_name,
                         out_name)
        mid_t0, out_t0 = t0_of(mid_name), t0_of(out_name)
        y = basic_block_slab_cat(
            getattr(p, name), a, b, _K_BLOCK, tbl, resl(a, t0_in, mid_t0),
            resl(a, t0_in, out_t0), dtype=dtype, t_off1=mid_t0 - t0_in,
            t_off2=out_t0 - mid_t0, train=train,
        )
        return y, out_t0

    def block(name, x_t, t0_in, tbl, mid_name, out_name):
        mid_t0, out_t0 = t0_of(mid_name), t0_of(out_name)
        y = basic_block_slab_pruned(
            getattr(p, name), x_t, _K_BLOCK, tbl, resl(x_t, t0_in, mid_t0),
            resl(x_t, t0_in, out_t0), dtype=dtype, t_off1=mid_t0 - t0_in,
            t_off2=out_t0 - mid_t0, train=train, chunk=chunk,
        )
        return y, out_t0

    # ---------------- encoder ----------------
    if maintained:
        # cached slots 0..W-2 were re-rowed by maintain_window_slab; the new
        # scan's stem output goes into slot W-1 at its merged rows. The
        # cache keeps its own dtype (float32: the stem's BN output).
        safe_new = torch.where(nslab.valid & (new_pos >= 0), new_pos,
                               caps[0]).long()
        col = torch.zeros((caps[0] + 1, C0), dtype=stem_shifted.dtype,
                          device=dev).index_put(
            (safe_new,), fresh_stem.feats.to(stem_shifted.dtype))
        merged = torch.cat([stem_shifted[:, :(W - 1) * C0], col[:caps[0]]],
                           dim=1)
        out_stem = x.replace_feats(merged)
        out_stem = out_stem.replace_feats(out_stem.mask_feats())
    elif stem_cache is not None:
        out_stem = _incremental_stem(p, cfg, x, coords3, point_valid, dims1,
                                     stem_cache, stats, dtype, cache_shift)
    else:
        out_stem = subm_block_slab(p.stem, x, _K_STEM, tables["stem"],
                                   dtype=dtype, train=train, chunk=chunk)
    if stem_cache is not None or emit_cache:
        stats["stem_cache"] = {"keys": x.keys, "feats": out_stem.feats}
        stats["win"] = {"keys": slab1.keys, "occ": slab1.occ}
    down = dict(dtype=dtype, with_occ=span, train=train, chunk=chunk)
    y = subm_block_slab(p.down1, out_stem, _K_DOWN, down_tables[2],
                        out=slabs[2], **down)
    out_b1, _ = block("block1", y, 0, tables[2], "b1m", "b1o")
    y = subm_block_slab(p.down2, out_b1, _K_DOWN, down_tables[4],
                        out=slabs[4], **down)
    out_b2, t_b2 = block("block2", y, 0, tables[4], "b2m", "b2o")
    y = subm_block_slab(p.down3, out_b2, _K_DOWN, down_tables[8],
                        out=sl(slabs[8], t_b2), **down)
    y, t_b3 = block("block3", y, t_b2, tables[8], "b3m", "b3o")

    # ---------------- decoder ----------------
    if prune_dec:
        def _prune_lat(t: Slab, lvl):
            idx, tpl = dec_idx[lvl], dec_tpl[lvl]
            return Slab(tpl.keys, tpl.coords, take_rows(t.occ, idx, False),
                        take_rows(t.feats, idx), tpl.valid, t.dims, t.T)

        lat4 = _prune_lat(out_b2, 4)
        lat2 = _prune_lat(out_b1, 2)
        lat1 = _prune_lat(out_stem, 1)
        tbl4, tbl2, tbl1 = dec_tbl[4], dec_tbl[2], dec_tbl[1]
    else:
        lat4, lat2, lat1 = out_b2, out_b1, out_stem
        tbl4, tbl2, tbl1 = tables[4], tables[2], tables[1]
    y = inverse_block_slab(p.up5, y, resl(lat4, t_b2, t_b3), parent_idx[4],
                           dtype=dtype, train=train)
    y, t_b6 = block_cat("block6", y, resl(lat4, t_b2, t_b3), t_b3, tbl4,
                        "b6m", "b6o")
    y = inverse_block_slab(p.up6, y, resl(lat2, 0, t_b6), parent_idx[2],
                           dtype=dtype, train=train)
    y, t_b7 = block_cat("block7", y, resl(lat2, 0, t_b6), t_b6, tbl2,
                        "b7m", "b7o")
    y = inverse_block_slab(p.up7, y, resl(lat1, 0, t_b7), parent_idx[1],
                           dtype=dtype, train=train)
    y, t_b8 = block_cat("block8", y, resl(lat1, 0, t_b7), t_b7, tbl1,
                        "b8m", "b8o")

    w_f = cast_compute(p.final.w, dtype)
    cout = w_f.shape[-1]
    Tf = y.T
    wk = torch.kron(torch.eye(Tf, device=dev), w_f.float()).to(w_f.dtype)
    logits = mm(y.feats, wk) + p.final.b.repeat(Tf)
    out = y.replace_feats(logits)
    out = out.replace_feats(out.mask_feats())
    if Tf == W:
        cur = gather_slots(out, p2slot, cout).reshape(W, P, cout)[W - 1]
    else:
        assert t_b8 == W - 1 and Tf == 1
        if maintained:
            # current points -> scan slab site -> merged window row
            sp = p2s_scan.clamp(0, new_pos.shape[0] - 1).long()
            mrow = new_pos[sp]
            site_or_neg = torch.where((p2s_scan >= 0) & (mrow >= 0), mrow, -1)
        else:
            p2s_cur = p2slot[(W - 1) * P:]
            site_or_neg = torch.where(
                p2s_cur >= 0, torch.div(p2s_cur, W, rounding_mode="floor"),
                -1)
        if prune_dec:
            # full-union site rows -> pruned-halo rows by key match
            cap0 = slab1.capacity
            keys_pad = torch.cat([slab1.keys, torch.full(
                (1,), KEY_SENTINEL, dtype=torch.int32, device=dev)])
            skeys = keys_pad[torch.where(site_or_neg >= 0, site_or_neg,
                                         cap0).long()]
            capp = dec_tpl[1].capacity
            pos = _bisect(dec_tpl[1].keys, skeys).clamp(0, capp - 1).long()
            hit = (dec_tpl[1].keys[pos] == skeys) & (site_or_neg >= 0)
            site_or_neg = torch.where(hit, pos.to(torch.int32), -1)
        cur = gather_slots(out, site_or_neg, cout)
    return cur, stats
