"""NN primitives (port of insmos_tpu/nn/layers.py), inference only.

Parameters live in ``nn.Module``s whose attribute names follow the JAX
parameter tree, so ``utils.params.load_jax_params`` maps tree paths to
state-dict keys one to one. Matmuls take operands in the compute dtype
(bf16 by default) and accumulate in float32: the operands are widened to
float32 before the product, which is exact for bf16 and matches the
reference's ``preferred_element_type=float32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def cast_compute(w: torch.Tensor, dtype_str: str | None) -> torch.Tensor:
    """Cast a matmul/conv weight (float32, ndim >= 2) to the compute dtype;
    BN parameters, biases and statistics stay float32."""
    if dtype_str in (None, "float32") or w.ndim < 2 or w.dtype != torch.float32:
        return w
    return w.to(getattr(torch, dtype_str))


def mm(x, w):
    """x @ w with operands rounded to w's dtype, float32 accumulation."""
    return x.to(w.dtype).float() @ w.float()


def linear(p, x, dtype_str=None):
    y = mm(x, cast_compute(p.w, dtype_str))
    return y + p.b if hasattr(p, "b") else y


def relu(x):
    return torch.clamp_min(x, 0.0)


class Linear(nn.Module):
    """(cin, cout) weight ``w`` and optional bias ``b`` (JAX layout)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout))
        if bias:
            self.b = nn.Parameter(torch.zeros(cout))


class SparseConv(nn.Module):
    """(K, cin, cout) sparse conv weight ``w``."""

    def __init__(self, K: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(K, cin, cout))


class Conv2d(nn.Module):
    """2D conv weight ``w`` in torch's (cout, cin, kh, kw) layout."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, kh, kw))


class ConvTranspose2d(nn.Module):
    """Transposed 2D conv weight ``w`` in torch's (cin, cout, kh, kw)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout, kh, kw))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm: ``scale``/``bias`` parameters, running
    ``mean``/``var`` buffers, and the owning network's eps."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def affine(self):
        """(scale', bias') with y = x * scale' + bias' (the slab form)."""
        s = self.scale * torch.rsqrt(self.var + self.eps)
        return s, self.bias - self.mean * s

    def forward(self, x):
        """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis
        (the reference's dense batch_norm form)."""
        return (x - self.mean) * torch.rsqrt(self.var + self.eps) * \
            self.scale + self.bias


def conv2d(x, w, stride: int = 1):
    """NCHW conv with TF-style SAME padding; float32 accumulation."""
    kh, kw = w.shape[2], w.shape[3]
    pads = []
    for size, k in ((x.shape[3], kw), (x.shape[2], kh)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x.to(w.dtype).float(), pads)
    return F.conv2d(x, w.float(), stride=stride)


def conv2d_transpose(x, w, stride: int = 2):
    """NCHW transposed conv, kernel == stride (exact upsample)."""
    return F.conv_transpose2d(x.to(w.dtype).float(), w.float(), stride=stride)
