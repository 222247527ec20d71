"""UNetV2: 3D sparse encoder/decoder with detection branch and instance
fusion (port of insmos_tpu/nn/unet3d.py), on the span engine for inference
and the windowed engine for training (minkunet4d.use_span_engine).

Encoder (16/32/64/128 channels at strides 1/2/4/8): conv_input, conv1,
then per level a stride-2 pad-1 conv and two subm convs, then the z-only
conv_out (kernel (1,1,3), stride (1,1,2)) to the encoded tensor handed to
the BEV/detection branch. The decoder fuses per-level instance one-hots of
the predicted boxes, and its UR blocks restore the finer site sets by
replaying the recorded strided-conv pairs (spconv SparseInverseConv3d).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.points_in_boxes import box_class_features
from ..sparse.bev import to_dense_bev
from ..sparse.convs import inverse_conv_pairs, strided_conv_sites
from ..sparse.slab import (Slab, site_grid, slab_from_sparse,
                           sparse_from_slab, window_tables)
from ..sparse.span_conv import make_span_plans
from .blocks_slab import (BasicBlock, ConvBN, basic_block_slab, cat_slab,
                          subm_block_slab)
from .layers import Linear, SparseConv, cast_compute, linear, relu

_K3 = (3, 3, 3)
_S2 = (2, 2, 2)
_P1 = (1, 1, 1)
_KZ = (1, 1, 3)  # z-only kernel: the reference's (3,1,1) in (z,y,x)
_SZ = (1, 1, 2)
_PZ = (0, 0, 0)
# reference norm_fn (unet3d._bn_of): eps, and the momentum that
# cfg.train.bn_momentum_scale scales
_EPS = 1e-3
_MOMENTUM = 0.01

# Plan budgets: the reference's literal values (unet3d.py:201-256).
PLAN_BUDGETS = {
    "block": {1: dict(span=192, slots=1536, gwin=48, pairs=1024),
              2: dict(span=192, slots=768, gwin=32, pairs=512),
              4: dict(span=192, slots=384, gwin=24, pairs=256),
              8: dict(span=384, slots=128, gwin=8)},
    "down": {2: dict(span=256, slots=512, gwin=12, pairs=1024),
             4: dict(span=256, slots=512, gwin=12, pairs=1024),
             8: dict(span=384, slots=128, gwin=12, pairs=512)},
    "out": dict(span=384, slots=128, gwin=8, pairs=256),
}


_BN = (_EPS, _MOMENTUM)


class UNet3D(nn.Module):
    """Parameters of UNetV2, named as the JAX tree (init_unet3d)."""

    def __init__(self, cfg):
        super().__init__()
        ch = cfg.model.unet_channels
        nc = cfg.model.head.num_class
        cin = cfg.model.point_features + 3
        k27 = 27
        self.conv_input = ConvBN(k27, cin, ch[0], *_BN)
        self.conv1 = ConvBN(k27, ch[0], ch[0], *_BN)
        for lvl in (2, 3, 4):
            setattr(self, f"conv{lvl}_down",
                    ConvBN(k27, ch[lvl - 2], ch[lvl - 1], *_BN))
            setattr(self, f"conv{lvl}_a",
                    ConvBN(k27, ch[lvl - 1], ch[lvl - 1], *_BN))
            setattr(self, f"conv{lvl}_b",
                    ConvBN(k27, ch[lvl - 1], ch[lvl - 1], *_BN))
        self.conv_out = ConvBN(3, ch[3], ch[3], *_BN)
        self.inv_conv_out = nn.Module()
        self.inv_conv_out.conv = SparseConv(3, ch[3], ch[3])
        self.fuse4 = ConvBN(k27, ch[3] + nc, ch[3], *_BN)
        self.fuse3 = ConvBN(k27, ch[2] + nc, ch[2], *_BN)
        self.fuse2 = ConvBN(k27, ch[1] + nc, ch[1], *_BN)
        self.fuse1 = ConvBN(k27, ch[0] + nc, ch[0], *_BN)
        self.fuse1_final = ConvBN(k27, ch[0] + nc, ch[0], *_BN)
        for lvl, c in ((4, ch[3]), (3, ch[2]), (2, ch[1]), (1, ch[0])):
            setattr(self, f"up_t{lvl}", BasicBlock(k27, c, c, False, *_BN))
            setattr(self, f"up_m{lvl}", ConvBN(k27, 2 * c, c, *_BN))
        self.inv4 = ConvBN(k27, ch[3], ch[2], *_BN)
        self.inv3 = ConvBN(k27, ch[2], ch[1], *_BN)
        self.inv2 = ConvBN(k27, ch[1], ch[0], *_BN)
        self.up_out = ConvBN(k27, ch[0], ch[0], *_BN)
        self.mos_head = Linear(ch[0], 3, bias=True)


def _channel_reduction(feats, cout: int):
    """(N, Cin) -> (N, cout) summing groups of Cin//cout adjacent channels."""
    n, cin = feats.shape
    return feats.reshape(n, cout, cin // cout).sum(dim=2)


def _inverse_block(p: ConvBN, coarse: Slab, fine_sites, pairs, kidx, dtype,
                   train):
    """Inverse conv (pair replay) + BN + ReLU."""
    y = inverse_conv_pairs(sparse_from_slab(coarse),
                           cast_compute(p.conv.w, dtype), fine_sites, pairs,
                           kidx, kernel_size=_K3, stride=_S2, pad=_P1)
    f = p.bn(y.feats, train, mask=y.valid)
    return slab_from_sparse(y.replace_feats(relu(f) * y.valid[:, None]))


def _ur_block(ps, lat: Slab, bot: Slab, table, fine_sites, pairs, dtype,
              train, last=False):
    """UR_block_forward: lateral residual fusion, then the inverse conv to
    the next finer site set (a subm conv at the last level)."""
    p_t, p_m, p_inv = ps
    x_t = basic_block_slab(p_t, lat, _K3, table, dtype=dtype, train=train)
    cat = cat_slab(bot, x_t)
    x_m = subm_block_slab(p_m, cat, _K3, table, dtype=dtype, train=train)
    fused = x_m.replace_feats(
        x_m.feats + _channel_reduction(cat.feats, x_m.num_features))
    fused = fused.replace_feats(fused.mask_feats())
    if last:
        return subm_block_slab(p_inv, fused, _K3, table, dtype=dtype,
                               train=train)
    prs, kis = pairs
    return _inverse_block(p_inv, fused, fine_sites, prs, kis, dtype, train)


def unet3d_forward(p: UNet3D, cfg, x, boxes_fn, train: bool = False):
    """x: voxelized current scan (SparseTensor, feats (V, 7)); boxes_fn maps
    the dense BEV (H, W, C) to (boxes (M, 8), valid (M,)). ``train`` runs
    the windowed engine (unless the config forces the span engine) and
    BatchNorm in train mode.

    Returns (mos voxel logits (V, 3), bev map, stats; "span_overflow" is
    empty on the windowed engine)."""
    from .minkunet4d import use_span_engine

    mc = cfg.model
    dtype = cfg.runtime.compute_dtype
    span = use_span_engine(cfg, train)
    gx, gy, gz = cfg.data.grid_size
    caps = mc.unet_capacities
    dims = {s: (-(-gx // s), -(-gy // s), -(-gz // s)) for s in (1, 2, 4, 8)}
    stats = {"sites": [], "dropped": []}
    B = PLAN_BUDGETS

    level_sites = {1: x}
    slabs = {1: slab_from_sparse(x)}
    tables, down_tables, pair_maps = {}, {}, {}
    for lvl, stride in ((2, 2), (3, 4), (4, 8)):
        fin = stride // 2
        s_in = slabs[fin]
        sites, prs, kis = strided_conv_sites(
            level_sites[fin], _K3, _S2, _P1, dims[stride], caps[lvl - 1],
            with_pairs=True)
        pair_maps[stride] = (prs, kis)
        level_sites[stride] = sites
        nxt = slab_from_sparse(sites.sites())
        if not span:
            grid = site_grid(s_in)
            tables[fin] = window_tables(grid, dims[fin], s_in.coords,
                                        s_in.valid, _K3, vin=s_in.capacity)
            down_tables[stride] = window_tables(
                grid, dims[fin], nxt.coords, nxt.valid, _K3, stride3=_S2,
                pad3=_P1, vin=s_in.capacity)
            slabs[stride] = nxt
            stats["sites"].append(sites.valid.sum())
            continue
        tables[fin], down_tables[stride] = make_span_plans(s_in.keys, [
            dict(out_coords=s_in.coords, out_valid=s_in.valid, kernel3=_K3,
                 in_dims=dims[fin], bs=128, **B["block"][fin]),
            dict(out_coords=nxt.coords, out_valid=nxt.valid, kernel3=_K3,
                 stride3=_S2, pad3=_P1, in_dims=dims[fin], bs=128,
                 **B["down"][stride]),
        ])
        slabs[stride] = nxt
        stats["sites"].append(sites.valid.sum())
    s8 = slabs[8]
    dims_out = (dims[8][0], dims[8][1], (dims[8][2] - _KZ[2]) // _SZ[2] + 1)
    sites_out, prs_out, kis_out = strided_conv_sites(
        level_sites[8], _KZ, _SZ, _PZ, dims_out, caps[4], with_pairs=True)
    if span:
        tables[8], out_tbl = make_span_plans(s8.keys, [
            dict(out_coords=s8.coords, out_valid=s8.valid, kernel3=_K3,
                 in_dims=dims[8], bs=128, **B["block"][8]),
            dict(out_coords=sites_out.coords, out_valid=sites_out.valid,
                 kernel3=_KZ, stride3=_SZ, pad3=_PZ, in_dims=dims[8], bs=128,
                 **B["out"]),
        ])
        stats["span_overflow"] = [
            tables[1].n_overflow, tables[2].n_overflow, tables[4].n_overflow,
            tables[8].n_overflow, down_tables[2].n_overflow,
            down_tables[4].n_overflow, down_tables[8].n_overflow,
            out_tbl.n_overflow,
        ]
    else:
        grid8 = site_grid(s8)
        tables[8] = window_tables(grid8, dims[8], s8.coords, s8.valid, _K3,
                                  vin=s8.capacity)
        out_tbl = window_tables(grid8, dims[8], sites_out.coords,
                                sites_out.valid, _KZ, stride3=_SZ, pad3=_PZ,
                                vin=s8.capacity)
        stats["span_overflow"] = []
    slab_out = slab_from_sparse(sites_out.sites())

    # ---------------- encoder ----------------
    bn = dict(dtype=dtype, train=train)
    y = subm_block_slab(p.conv_input, slabs[1].replace_feats(x.masked_feats()),
                        _K3, tables[1], **bn)
    x_conv1 = subm_block_slab(p.conv1, y, _K3, tables[1], **bn)
    enc = {1: x_conv1}
    y = x_conv1
    for lvl, stride in ((2, 2), (3, 4), (4, 8)):
        y = subm_block_slab(getattr(p, f"conv{lvl}_down"), y, _K3,
                            down_tables[stride], out=slabs[stride], **bn)
        y = subm_block_slab(getattr(p, f"conv{lvl}_a"), y, _K3,
                            tables[stride], **bn)
        y = subm_block_slab(getattr(p, f"conv{lvl}_b"), y, _K3,
                            tables[stride], **bn)
        enc[stride] = y
    encoded = subm_block_slab(p.conv_out, y, _KZ, out_tbl, out=slab_out,
                              **bn)

    # ---------------- detection branch on the dense BEV ----------------
    bev = to_dense_bev(sparse_from_slab(encoded))
    boxes_world, box_valid = boxes_fn(bev)

    # ---------------- decoder with instance fusion ---------------------
    sparse_inv = inverse_conv_pairs(
        sparse_from_slab(encoded), cast_compute(p.inv_conv_out.conv.w, dtype),
        level_sites[8].sites(), prs_out, kis_out, kernel_size=_KZ,
        stride=_SZ, pad=_PZ)
    y = slab_from_sparse(sparse_inv.replace_feats(sparse_inv.masked_feats()))

    dev = x.feats.device
    vs = torch.tensor(cfg.data.voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(cfg.data.point_cloud_range[:3], dtype=torch.float32,
                      device=dev)

    def to_grid(b8, stride):
        ctr = (b8[:, 0:3] - lo[None]) / (vs[None] * stride)
        dms = b8[:, 3:6] / (vs[None] * stride)
        return torch.cat([ctr, dms, b8[:, 6:8]], dim=-1)

    nc = mc.head.num_class

    def fuse(level_slab: Slab, stride, fuse_p):
        inst = box_class_features(
            level_slab.coords.to(torch.float32), to_grid(boxes_world, stride),
            nc, box_valid) * level_slab.valid[:, None]
        cat = level_slab.replace_feats(torch.cat([level_slab.feats, inst],
                                                 dim=-1))
        return subm_block_slab(fuse_p, cat, _K3, tables[stride],
                               **bn), inst

    y, _ = fuse(y, 8, p.fuse4)
    x_up4 = _ur_block((p.up_t4, p.up_m4, p.inv4), y, y, tables[8],
                      level_sites[4].sites(), pair_maps[8], dtype, train)
    y, _ = fuse(x_up4, 4, p.fuse3)
    x_up3 = _ur_block((p.up_t3, p.up_m3, p.inv3), enc[4], y, tables[4],
                      level_sites[2].sites(), pair_maps[4], dtype, train)
    y, _ = fuse(x_up3, 2, p.fuse2)
    x_up2 = _ur_block((p.up_t2, p.up_m2, p.inv2), enc[2], y, tables[2],
                      level_sites[1].sites(), pair_maps[2], dtype, train)
    y, inst1 = fuse(x_up2, 1, p.fuse1)
    x_up1 = _ur_block((p.up_t1, p.up_m1, p.up_out), enc[1], y, tables[1],
                      None, None, dtype, train, last=True)
    # the final fusion reuses the stride-1 instance features (stride-1
    # plan reused as in the reference)
    cat = x_up1.replace_feats(torch.cat([x_up1.feats, inst1], dim=-1))
    y = subm_block_slab(p.fuse1_final, cat, _K3, tables[1], **bn)
    logits = linear(p.mos_head, y.feats, dtype)
    return logits * y.valid[:, None], bev, stats
