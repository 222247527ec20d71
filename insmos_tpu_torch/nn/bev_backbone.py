"""Dense 2D BEV backbone (port of insmos_tpu/nn/bev_backbone.py): per
level 1 + layer_nums 3x3 convs + BN + ReLU, then a transposed-conv upsample
+ BN + ReLU. Runs NCHW on torch.nn.functional convs (the reference leaves
these to XLA); inputs and outputs stay HWC as in the reference."""

from __future__ import annotations

import torch
from torch import nn

from .layers import (BatchNorm, Conv2d, ConvTranspose2d, cast_compute,
                     conv2d, conv2d_transpose, relu)

_EPS = 1e-3  # reference norm_fn eps (bev_backbone._bn_of)


class BEVLevel(nn.Module):
    def __init__(self, cin: int, nf: int, n_layers: int):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv2d(3, 3, cin if k == 0 else nf, nf) for k in range(n_layers + 1)
        )
        self.bns = nn.ModuleList(BatchNorm(nf, _EPS)
                                 for _ in range(n_layers + 1))


class Deblock(nn.Module):
    def __init__(self, s: int, cin: int, cout: int):
        super().__init__()
        self.conv = ConvTranspose2d(s, s, cin, cout)
        self.bn = BatchNorm(cout, _EPS)


class BEVBackbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        b = cfg.model.bev
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        for lvl in range(len(b.layer_nums)):
            c_in = b.num_bev_features if lvl == 0 else b.num_filters[lvl - 1]
            self.blocks.append(BEVLevel(c_in, b.num_filters[lvl],
                                        b.layer_nums[lvl]))
            self.deblocks.append(Deblock(b.upsample_strides[lvl],
                                         b.num_filters[lvl],
                                         b.num_upsample_filters[lvl]))


def _bn_chw(bn: BatchNorm, x):
    """Dense-form BatchNorm over the channel axis of (1, C, H, W)."""
    return bn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def bev_backbone_forward(p: BEVBackbone, cfg, bev, dtype=None):
    """bev (H, W, C) -> (H*up, W*up, C_up)."""
    b = cfg.model.bev
    x = bev.permute(2, 0, 1)[None]
    ups = []
    for lvl in range(len(b.layer_nums)):
        blk = p.blocks[lvl]
        for k, (cv, bn) in enumerate(zip(blk.convs, blk.bns)):
            stride = b.layer_strides[lvl] if k == 0 else 1
            x = relu(_bn_chw(bn, conv2d(x, cast_compute(cv.w, dtype),
                                        stride=stride)))
        db = p.deblocks[lvl]
        u = conv2d_transpose(x, cast_compute(db.conv.w, dtype),
                             stride=b.upsample_strides[lvl])
        ups.append(relu(_bn_chw(db.bn, u)))
    y = ups[0] if len(ups) == 1 else torch.cat(ups, dim=1)
    return y[0].permute(1, 2, 0)
