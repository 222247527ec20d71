"""Slab-space network blocks (port of insmos_tpu/nn/blocks_slab.py and the
block constructors of insmos_tpu/nn/blocks.py).

Activations are re-masked after every op so non-occupied slots stay zero
(the engine invariant both conv engines rely on). BatchNorm statistics, in
train mode, run over the occupied (site, t) slots only: the rows the
reference's BatchNorm1d sees. ``tbl`` is a span_conv.SpanPlan or a
slab.WindowTables; both expose ``.conv``, and ``chunk`` reaches the
windowed engine only.
"""

from __future__ import annotations

import torch
from torch import nn

from ..sparse.slab import Slab, inverse_s2k2_conv, slice_slots
from .layers import BatchNorm, SparseConv, cast_compute, mm, relu


class ConvBN(nn.Module):
    """conv + BN (JAX init_conv_bn): ``conv.w`` (K, cin, cout), ``bn``."""

    def __init__(self, K: int, cin: int, cout: int, eps: float,
                 momentum: float):
        super().__init__()
        self.conv = SparseConv(K, cin, cout)
        self.bn = BatchNorm(cout, eps, momentum)


class BasicBlock(nn.Module):
    """Residual block (JAX init_basic_block): conv1/bn1, conv2/bn2 and,
    with ``downsample``, a 1x1 ``down`` conv + ``down_bn``."""

    def __init__(self, K: int, cin: int, cout: int, downsample: bool,
                 eps: float, momentum: float):
        super().__init__()
        self.conv1 = SparseConv(K, cin, cout)
        self.bn1 = BatchNorm(cout, eps, momentum)
        self.conv2 = SparseConv(K, cout, cout)
        self.bn2 = BatchNorm(cout, eps, momentum)
        if downsample:
            self.down = SparseConv(1, cin, cout)
            self.down_bn = BatchNorm(cout, eps, momentum)


def _bn_slab(bn: BatchNorm, y: Slab, train: bool = False):
    """BatchNorm on flat (V, T*C) features. In train mode the statistics
    are one-pass sums over the occupied (site, t) rows (non-occupied slots
    hold exact zeros, so the sums need no mask), var = max(s2/n - mean^2,
    0)."""
    if train:
        T, C = y.T, y.num_features
        f = y.feats
        n = torch.clamp((y.occ & y.valid[:, None]).sum().to(torch.float32),
                        min=1.0)
        mean = f.sum(dim=0).reshape(T, C).sum(dim=0) / n
        var = torch.clamp((f * f).sum(dim=0).reshape(T, C).sum(dim=0) / n
                          - mean * mean, min=0.0)
        bn.record(mean, var, n)
        s = bn.scale * torch.rsqrt(var + bn.eps)
        b = bn.bias - mean * s
    else:
        s, b = bn.affine()
    return y.feats * s.repeat(y.T)[None] + b.repeat(y.T)[None]


def _kron_eye(T: int, w):
    """Block-diagonal (T*cin, T*cout) weight: the per-t 1x1 conv."""
    return torch.kron(torch.eye(T, dtype=torch.float32, device=w.device),
                      w.float()).to(w.dtype)


def _conv(tbl, x, w, out, kernel, chunk, t0_off=0):
    kw = {"chunk": chunk} if chunk is not None else {}
    return tbl.conv(x, w, out, kernel, t0_off=t0_off, **kw)


def subm_block_slab(p: ConvBN, x: Slab, kernel, tbl, out: Slab | None = None,
                    *, dtype=None, with_occ=False, train=False, chunk=None):
    """conv + BN + ReLU; strided when ``out`` is given. ``with_occ`` folds
    the occupancy propagation into the conv (span strided convs)."""
    w = cast_compute(p.conv.w, dtype)
    if with_occ:
        y = tbl.conv_with_occ(x, w, out, kernel)
    else:
        y = _conv(tbl, x, w, out if out is not None else x, kernel, chunk)
    y = y.replace_feats(relu(_bn_slab(p.bn, y, train)))
    return y.replace_feats(y.mask_feats())


def basic_block_slab_pruned(p: BasicBlock, x: Slab, kernel, tbl, mid: Slab,
                            out: Slab, *, dtype=None, t_off1=0, t_off2=0,
                            train=False, chunk=None):
    """Residual block over a trailing slot window (t-pruned inference):
    conv1 maps x's slots to mid's (offset t_off1), conv2 to out's (offset
    t_off2); the identity is the matching slot slice of x. With mid and out
    equal to x it is the plain residual block."""
    y = _conv(tbl, x, cast_compute(p.conv1.w, dtype), mid, kernel, chunk,
              t_off1)
    y = y.replace_feats(y.mask_feats(relu(_bn_slab(p.bn1, y, train))))
    y = _conv(tbl, y, cast_compute(p.conv2.w, dtype), out, kernel, chunk,
              t_off2)
    f = _bn_slab(p.bn2, y, train)
    idt_in = slice_slots(x, t_off1 + t_off2, out.T)
    if hasattr(p, "down"):
        w_dn = cast_compute(p.down.w, dtype)[0]
        idt = mm(idt_in.feats, _kron_eye(out.T, w_dn))
        idt = _bn_slab(p.down_bn, idt_in.replace_feats(idt), train)
    else:
        idt = idt_in.feats
    res = y.replace_feats(relu(f + idt))
    return res.replace_feats(res.mask_feats())


def basic_block_slab_cat(p: BasicBlock, a: Slab, b: Slab, kernel, tbl,
                         mid: Slab, out: Slab, *, dtype=None, t_off1=0,
                         t_off2=0, train=False):
    """basic_block_slab_pruned over cat(a, b) with channel-split weights
    (span engine)."""
    ca = a.num_features
    y = tbl.conv_cat(a, b, cast_compute(p.conv1.w, dtype), mid, kernel,
                     t0_off=t_off1)
    y = y.replace_feats(y.mask_feats(relu(_bn_slab(p.bn1, y, train))))
    y = tbl.conv(y, cast_compute(p.conv2.w, dtype), out, kernel,
                 t0_off=t_off2)
    f = _bn_slab(p.bn2, y, train)
    ia = slice_slots(a, t_off1 + t_off2, out.T)
    ib = slice_slots(b, t_off1 + t_off2, out.T)
    w_dn = cast_compute(p.down.w, dtype)[0]
    idt = mm(ia.feats, _kron_eye(out.T, w_dn[:ca])) + mm(
        ib.feats, _kron_eye(out.T, w_dn[ca:]))
    idt = _bn_slab(p.down_bn, ia.replace_feats(idt), train)
    res = y.replace_feats(relu(f + idt))
    return res.replace_feats(res.mask_feats())


def inverse_block_slab(p: ConvBN, coarse: Slab, fine: Slab, parent_idx, *,
                       dtype=None, train=False):
    """Stride-2 kernel-2 inverse conv + BN + ReLU."""
    y = inverse_s2k2_conv(coarse, cast_compute(p.conv.w, dtype), fine,
                          parent_idx)
    y = y.replace_feats(relu(_bn_slab(p.bn, y, train)))
    return y.replace_feats(y.mask_feats())


def basic_block_slab(p: BasicBlock, x: Slab, kernel, tbl, *, dtype=None,
                     train=False, chunk=None):
    """Residual block on one site set (the UNet's T=1 blocks)."""
    return basic_block_slab_pruned(p, x, kernel, tbl, x, x, dtype=dtype,
                                   train=train, chunk=chunk)


def cat_slab(a: Slab, b: Slab) -> Slab:
    """Channel concat of two slabs on one site set, per-t interleaved."""
    T = a.T
    ca, cb = a.num_features, b.num_features
    cols = []
    for t in range(T):
        cols.append(a.feats[:, t * ca:(t + 1) * ca])
        cols.append(b.feats[:, t * cb:(t + 1) * cb])
    return a.replace_feats(torch.cat(cols, dim=-1))
