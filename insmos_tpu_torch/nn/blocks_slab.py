"""Slab-space network blocks (port of insmos_tpu/nn/blocks_slab.py and the
block constructors of insmos_tpu/nn/blocks.py), eval-mode BatchNorm.

Activations are re-masked after every op so non-occupied slots stay zero
(the engine invariant the span conv relies on).
"""

from __future__ import annotations

import torch
from torch import nn

from ..sparse.slab import Slab, inverse_s2k2_conv, slice_slots
from .layers import BatchNorm, SparseConv, cast_compute, mm, relu


class ConvBN(nn.Module):
    """conv + BN (JAX init_conv_bn): ``conv.w`` (K, cin, cout), ``bn``."""

    def __init__(self, K: int, cin: int, cout: int, eps: float):
        super().__init__()
        self.conv = SparseConv(K, cin, cout)
        self.bn = BatchNorm(cout, eps)


class BasicBlock(nn.Module):
    """Residual block (JAX init_basic_block): conv1/bn1, conv2/bn2 and,
    with ``downsample``, a 1x1 ``down`` conv + ``down_bn``."""

    def __init__(self, K: int, cin: int, cout: int, downsample: bool,
                 eps: float):
        super().__init__()
        self.conv1 = SparseConv(K, cin, cout)
        self.bn1 = BatchNorm(cout, eps)
        self.conv2 = SparseConv(K, cout, cout)
        self.bn2 = BatchNorm(cout, eps)
        if downsample:
            self.down = SparseConv(1, cin, cout)
            self.down_bn = BatchNorm(cout, eps)


def _bn_slab(bn: BatchNorm, y: Slab):
    """Eval BatchNorm on flat (V, T*C) features."""
    s, b = bn.affine()
    return y.feats * s.repeat(y.T)[None] + b.repeat(y.T)[None]


def _kron_eye(T: int, w):
    """Block-diagonal (T*cin, T*cout) weight: the per-t 1x1 conv."""
    return torch.kron(torch.eye(T, dtype=torch.float32, device=w.device),
                      w.float()).to(w.dtype)


def subm_block_slab(p: ConvBN, x: Slab, kernel, tbl, out: Slab | None = None,
                    *, dtype=None, with_occ=False):
    """conv + BN + ReLU; strided when ``out`` is given. ``tbl`` is a
    span_conv.SpanPlan."""
    w = cast_compute(p.conv.w, dtype)
    if with_occ:
        y = tbl.conv_with_occ(x, w, out, kernel)
    else:
        y = tbl.conv(x, w, out if out is not None else x, kernel)
    y = y.replace_feats(relu(_bn_slab(p.bn, y)))
    return y.replace_feats(y.mask_feats())


def basic_block_slab_pruned(p: BasicBlock, x: Slab, kernel, tbl, mid: Slab,
                            out: Slab, *, dtype=None, t_off1=0, t_off2=0):
    """Residual block over a trailing slot window (t-pruned inference)."""
    y = tbl.conv(x, cast_compute(p.conv1.w, dtype), mid, kernel,
                 t0_off=t_off1)
    y = y.replace_feats(y.mask_feats(relu(_bn_slab(p.bn1, y))))
    y = tbl.conv(y, cast_compute(p.conv2.w, dtype), out, kernel,
                 t0_off=t_off2)
    f = _bn_slab(p.bn2, y)
    idt_in = slice_slots(x, t_off1 + t_off2, out.T)
    if hasattr(p, "down"):
        w_dn = cast_compute(p.down.w, dtype)[0]
        idt = mm(idt_in.feats, _kron_eye(out.T, w_dn))
        idt = _bn_slab(p.down_bn, idt_in.replace_feats(idt))
    else:
        idt = idt_in.feats
    res = y.replace_feats(relu(f + idt))
    return res.replace_feats(res.mask_feats())


def basic_block_slab_cat(p: BasicBlock, a: Slab, b: Slab, kernel, tbl,
                         mid: Slab, out: Slab, *, dtype=None, t_off1=0,
                         t_off2=0):
    """basic_block_slab_pruned over cat(a, b) with channel-split weights."""
    ca = a.num_features
    y = tbl.conv_cat(a, b, cast_compute(p.conv1.w, dtype), mid, kernel,
                     t0_off=t_off1)
    y = y.replace_feats(y.mask_feats(relu(_bn_slab(p.bn1, y))))
    y = tbl.conv(y, cast_compute(p.conv2.w, dtype), out, kernel,
                 t0_off=t_off2)
    f = _bn_slab(p.bn2, y)
    ia = slice_slots(a, t_off1 + t_off2, out.T)
    ib = slice_slots(b, t_off1 + t_off2, out.T)
    w_dn = cast_compute(p.down.w, dtype)[0]
    idt = mm(ia.feats, _kron_eye(out.T, w_dn[:ca])) + mm(
        ib.feats, _kron_eye(out.T, w_dn[ca:]))
    idt = _bn_slab(p.down_bn, ia.replace_feats(idt))
    res = y.replace_feats(relu(f + idt))
    return res.replace_feats(res.mask_feats())


def inverse_block_slab(p: ConvBN, coarse: Slab, fine: Slab, parent_idx, *,
                       dtype=None):
    """Stride-2 kernel-2 inverse conv + BN + ReLU."""
    y = inverse_s2k2_conv(coarse, cast_compute(p.conv.w, dtype), fine,
                          parent_idx)
    y = y.replace_feats(relu(_bn_slab(p.bn, y)))
    return y.replace_feats(y.mask_feats())


def basic_block_slab(p: BasicBlock, x: Slab, kernel, tbl, *, dtype=None):
    """Residual block on one site set (the UNet's T=1 blocks)."""
    y = tbl.conv(x, cast_compute(p.conv1.w, dtype), x, kernel)
    y = y.replace_feats(y.mask_feats(relu(_bn_slab(p.bn1, y))))
    y = tbl.conv(y, cast_compute(p.conv2.w, dtype), y, kernel)
    f = _bn_slab(p.bn2, y)
    if hasattr(p, "down"):
        w_dn = cast_compute(p.down.w, dtype)[0]
        idt = mm(x.feats, _kron_eye(x.T, w_dn))
        idt = _bn_slab(p.down_bn, x.replace_feats(idt))
    else:
        idt = x.feats
    res = y.replace_feats(relu(f + idt))
    return res.replace_feats(res.mask_feats())


def cat_slab(a: Slab, b: Slab) -> Slab:
    """Channel concat of two slabs on one site set, per-t interleaved."""
    T = a.T
    ca, cb = a.num_features, b.num_features
    cols = []
    for t in range(T):
        cols.append(a.feats[:, t * ca:(t + 1) * ca])
        cols.append(b.feats[:, t * cb:(t + 1) * cb])
    return a.replace_feats(torch.cat(cols, dim=-1))
