"""VoxelResBackBone8x (OpenPCDet ``backbones_3d/spconv_backbone.py``), the
residual sparse encoder of CenterPoint, on the span engine.

Widths 16/32/64/128 at strides 1/2/4/8: ``conv_input`` (subm 3^3, BN,
ReLU), ``conv1`` (two ``SparseBasicBlock``s), then per level a strided
3^3 conv (stride 2, pad 1; the last with pad 0 in z) with BN and ReLU and
two blocks, then ``conv_out`` (kernel 3 in z, stride 2 in z, pad 0) with
BN and ReLU. BN eps 1e-3. A block is ``relu(bn2(conv2(relu(bn1(conv1(x)))))
+ x)``; OpenPCDet's block convs carry a bias, which :func:`fold_block_bias`
folds into the BN's running mean when the weights are loaded, so the
blocks are the shared ``BasicBlock`` of ``nn/blocks_slab.py``.

Coordinates are (x, y, z), x fastest, as everywhere in the port: spconv's
(z, y, x) padding (0, 1, 1) is (1, 1, 0) here and its (3, 1, 1) kernel
(1, 1, 3).
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ..sparse.slab import Slab, derive_strided_sites, slab_from_sparse
from ..sparse.span_conv import make_span_plans
from .blocks_slab import BasicBlock, ConvBN, basic_block_slab, subm_block_slab

_K3 = (3, 3, 3)
_S2 = (2, 2, 2)
_P1 = (1, 1, 1)
_P4 = (1, 1, 0)  # conv4: spconv's padding (0, 1, 1) in (z, y, x)
_KZ = (1, 1, 3)  # conv_out: spconv's (3, 1, 1)
_SZ = (1, 1, 2)
_PZ = (0, 0, 0)
_EPS = 1e-3
_MOMENTUM = 0.01
_BN = (_EPS, _MOMENTUM)
N_BLOCKS = 2  # SparseBasicBlocks a level
# a block conv's bias: <...>.conv<level>.<block>.conv<1|2>.b
_BLOCK_BIAS = re.compile(r"(\.conv\d\.\d+)\.conv([12])\.b$")

# Plan budgets, chosen from what the nus32 drive measured at the full
# configuration on the card (24 windows: 4 seeds x 6 steps; PERF.md §4).
# Sites at most: 140,068 voxels, 169,943 / 71,917 / 21,401 at strides 2 /
# 4 / 8, 19,230 after conv_out; output blocks of 128 at most 1,095, 1,328,
# 562, 168 and 151. Per plan: the most (group, block) pairs whose key
# interval outran the main window ("jumps") and the most coverage slots
# used, at the budget below; each budget has no uncovered row on any of the
# 24 windows. "rows" is the widest (group, block) key interval in input
# rows (its 99th percentile in brackets). Keys: the subm convs of a level
# by its stride, the strided convs by the stride they produce.
PLAN_BUDGETS = {
    "block": {
        # rows 74,384 (p99 1,537); span 384 / 48 rounds: 351 jumps, 894
        # slots (24 rounds left rows uncovered on 5 windows, up to 189)
        1: dict(span=384, slots=1536, gwin=64, pairs=768),
        # rows 20,752 (1,120); 384 / 24: 270 jumps, 524 slots
        2: dict(span=384, slots=1024, gwin=48, pairs=640),
        # rows 9,856 (976); 256 / 24: 192 jumps, 352 slots
        4: dict(span=256, slots=768, gwin=32, pairs=512),
        # rows 3,440 (767); 256 / 12: 39 jumps, 80 slots
        8: dict(span=256, slots=256, gwin=16, pairs=128)},
    "down": {
        # rows 91,520 (1,936); 256 / 12: 817 jumps, 817 slots
        2: dict(span=256, slots=1536, gwin=12, pairs=1536),
        # rows 75,952 (4,243); 256 / 12: 1,379 jumps, 1,380 slots
        4: dict(span=256, slots=2560, gwin=12, pairs=2560),
        # rows 31,328 (3,206); 256 / 12: 697 jumps, 742 slots
        8: dict(span=256, slots=1280, gwin=12, pairs=1280)},
    # rows 9,728 (771); 256 / 8: 3 jumps, 3 slots
    "out": dict(span=256, slots=64, gwin=8, pairs=64),
}


class VoxelResBackBone8x(nn.Module):
    """Parameters: ``conv_input``, ``conv{1..4}`` (ModuleLists of blocks),
    ``conv{2..4}_down`` and ``conv_out``; sparse weights (K, cin, cout), K
    x fastest over the kernel."""

    def __init__(self, cfg):
        super().__init__()
        ch = cfg.model.backbone.channels
        k27 = 27
        self.conv_input = ConvBN(k27, cfg.model.point_features, ch[0], *_BN)
        for lvl in range(1, 5):
            c = ch[lvl - 1]
            if lvl > 1:
                setattr(self, f"conv{lvl}_down",
                        ConvBN(k27, ch[lvl - 2], c, *_BN))
            setattr(self, f"conv{lvl}", nn.ModuleList(
                BasicBlock(k27, c, c, False, *_BN) for _ in range(N_BLOCKS)))
        self.conv_out = ConvBN(3, ch[3], ch[3], *_BN)


def fold_block_bias(sd: dict) -> dict:
    """A state dict with OpenPCDet's block conv biases (``<block>.conv1.b``,
    ``<block>.conv2.b``) -> the port's, each bias folded into the BN that
    follows its conv (running mean - bias), the bias keys removed. BN of a
    conv plus bias equals BN with that mean of the conv alone."""
    out = dict(sd)
    for k in sd:
        hit = _BLOCK_BIAS.search(k)
        if hit:
            bn = f"{k[:hit.start()]}{hit.group(1)}.bn{hit.group(2)}.mean"
            out[bn] = sd[bn] - sd[k]
            del out[k]
    return out


def conv_out_dims(dims, kernel, stride, pad) -> tuple:
    """Output dims of a strided sparse conv (spconv's formula)."""
    return tuple((d + 2 * p - k) // s + 1
                 for d, k, s, p in zip(dims, kernel, stride, pad))


def level_dims(cfg) -> dict:
    """Dims of every level: strides 1, 2, 4, 8 and ``out``."""
    d = {1: tuple(cfg.data.sparse_shape)}
    d[2] = conv_out_dims(d[1], _K3, _S2, _P1)
    d[4] = conv_out_dims(d[2], _K3, _S2, _P1)
    d[8] = conv_out_dims(d[4], _K3, _S2, _P4)
    d["out"] = conv_out_dims(d[8], _KZ, _SZ, _PZ)
    return d


def backbone3d_forward(p: VoxelResBackBone8x, cfg, x, dtype=None):
    """x: the voxels (SparseTensor over ``sparse_shape``, feats (V, 5)).
    Returns (the encoded SparseTensor over the ``out`` dims, 128
    channels; stats: ``span_overflow`` (8,) of the plans, in the order
    subm 1, 2, 4, 8, down 2, 4, 8, out; ``sites_dropped`` (4,) at strides
    2, 4, 8 and out)."""
    dims = level_dims(cfg)
    caps = cfg.model.backbone.site_capacities
    B = PLAN_BUDGETS
    geo = {2: (_K3, _S2, _P1), 4: (_K3, _S2, _P1), 8: (_K3, _S2, _P4),
           "out": (_KZ, _SZ, _PZ)}
    slabs = {1: slab_from_sparse(x)}
    dropped = []
    for (fin, s), cap in zip(((1, 2), (2, 4), (4, 8), (8, "out")), caps):
        o, _, n_dropped = derive_strided_sites(slabs[fin], *geo[s], dims[s],
                                               cap)
        # every output site holds its one (T = 1) slot
        slabs[s] = Slab(o.keys, o.coords, o.valid[:, None], o.feats, o.valid,
                        o.dims, 1)
        dropped.append(n_dropped)
    subm, down = {}, {}
    for fin, s in ((1, 2), (2, 4), (4, 8), (8, "out")):
        nxt = slabs[s]
        k, st, pd = geo[s]
        budget = B["out"] if s == "out" else B["down"][s]
        subm[fin], down[s] = make_span_plans(slabs[fin].keys, [
            dict(out_coords=slabs[fin].coords, out_valid=slabs[fin].valid,
                 kernel3=_K3, in_dims=dims[fin], bs=128, **B["block"][fin]),
            dict(out_coords=nxt.coords, out_valid=nxt.valid, kernel3=k,
                 stride3=st, pad3=pd, in_dims=dims[fin], bs=128, **budget),
        ])
    stats = {
        "span_overflow": torch.stack(
            [subm[s].n_overflow for s in (1, 2, 4, 8)]
            + [down[s].n_overflow for s in (2, 4, 8, "out")]),
        "sites_dropped": torch.stack(dropped),
    }

    bn = dict(dtype=dtype)
    y = subm_block_slab(p.conv_input, slabs[1].replace_feats(x.masked_feats()),
                        _K3, subm[1], **bn)
    for lvl, s in ((1, 1), (2, 2), (3, 4), (4, 8)):
        if lvl > 1:
            y = subm_block_slab(getattr(p, f"conv{lvl}_down"), y, geo[s][0],
                                down[s], out=slabs[s], **bn)
        for blk in getattr(p, f"conv{lvl}"):
            y = basic_block_slab(blk, y, _K3, subm[s], **bn)
    y = subm_block_slab(p.conv_out, y, _KZ, down["out"], out=slabs["out"],
                        **bn)
    return y, stats
