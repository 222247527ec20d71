"""NN primitives (port of insmos_tpu/nn/layers.py).

Parameters live in ``nn.Module``s whose attribute names follow the JAX
parameter tree, so ``utils.params.load_jax_params`` maps tree paths to
state-dict keys one to one. Matmuls take operands in the compute dtype
(bf16 by default) and accumulate in float32: the operands are widened to
float32 before the product, which is exact for bf16 and matches the
reference's ``preferred_element_type=float32``.

BatchNorm follows torch semantics in both modes: in train mode it
normalises by the batch's biased variance over the rows that exist (padding
rows excluded) and computes the running statistics' update, new = (1 - m) *
old + m * batch with the unbiased variance, which the caller applies
(``collect_bn_state``): a batch's samples each normalise with their own
statistics and their updates are averaged, as the reference's vmap does.
"""

from __future__ import annotations

import contextlib

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
    """BatchNorm with ``scale``/``bias`` parameters, running ``mean``/``var``
    buffers and the owning network's eps. The momentum is ``base_momentum``
    (0.1 in MinkowskiEngine's MotionNet, 0.01 in the spconv UNet and the
    BEV backbone) times ``momentum_scale`` (the config's
    ``bn_momentum_scale``), at most 1. A train-mode call leaves the update
    of the running statistics in ``new_stats`` (detached)."""

    def __init__(self, c: int, eps: float, base_momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.base_momentum = base_momentum
        self.momentum_scale = 1.0
        self.new_stats = None
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def affine(self):
        """(scale', bias') with y = x * scale' + bias' (the slab form)."""
        s = self.scale * torch.rsqrt(self.var + self.eps)
        return s, self.bias - self.mean * s

    def record(self, mean, var, n):
        """Keep the running statistics' update from a batch's mean and
        biased variance over ``n`` rows."""
        m = min(1.0, self.base_momentum * self.momentum_scale)
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        self.new_stats = ((1 - m) * self.mean + m * mean.detach(),
                          (1 - m) * self.var + m * unbiased.detach())

    def forward(self, x, train: bool = False, mask=None):
        """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis
        (the reference's dense batch_norm form). In train mode the
        statistics are the batch's, two-pass, over the rows where ``mask``
        (broadcastable to x[..., 0]) holds, or over all rows."""
        if not train:
            return (x - self.mean) * torch.rsqrt(self.var + self.eps) * \
                self.scale + self.bias
        axes = tuple(range(x.ndim - 1))
        if mask is None:
            n = torch.tensor(float(x[..., 0].numel()), device=x.device)
            mean = x.mean(dim=axes)
            var = ((x - mean) ** 2).mean(dim=axes)
        else:
            m = mask.to(x.dtype)[..., None]
            n = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(dim=axes) / n
            var = (((x - mean) ** 2) * m).sum(dim=axes) / n
        self.record(mean, var, n)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + \
            self.bias


def bn_modules(model: nn.Module):
    """(name, BatchNorm) of every BatchNorm under ``model``."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, BatchNorm)]


def set_bn_momentum_scale(model: nn.Module, scale: float) -> None:
    for _, m in bn_modules(model):
        m.momentum_scale = scale


def clear_bn_state(model: nn.Module) -> None:
    for _, m in bn_modules(model):
        m.new_stats = None


def collect_bn_state(model: nn.Module) -> dict:
    """The BN state after a train-mode forward, as state-dict entries
    (``<module>.mean`` / ``<module>.var``): each BatchNorm's recorded
    update, or its running statistics where it did not run in train mode."""
    out = {}
    for name, m in bn_modules(model):
        mean, var = m.new_stats if m.new_stats is not None else (m.mean,
                                                                 m.var)
        out[f"{name}.mean"], out[f"{name}.var"] = mean, var
    return out


def conv2d(x, w, stride: int = 1):
    """NCHW conv with TF-style SAME padding; float32 accumulation, on
    PyTorch's own convolution (see :func:`_per_sample_conv`)."""
    kh, kw = w.shape[2], w.shape[3]
    pads = []
    for size, k in ((x.shape[3], kw), (x.shape[2], kh)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x.to(w.dtype).float(), pads)
    with _per_sample_conv():
        return F.conv2d(x, w.float(), stride=stride)


def conv2d_transpose(x, w, stride: int = 2):
    """NCHW transposed conv, kernel == stride (exact upsample)."""
    with _per_sample_conv():
        return F.conv_transpose2d(x.to(w.dtype).float(), w.float(),
                                  stride=stride)


def _per_sample_conv():
    """cuDNN off for the BEV convolutions at inference (no autograd).
    cuDNN picks its algorithm (and its workspace) by the batch size:
    vmapped over a pod's slots the convs ran another algorithm than one
    stream's, with other float32 sums and a 16 GiB workspace at the full
    Config on an H100. PyTorch's own convolution computes each sample alone
    (im2col and one GEMM), so a slot's output does not depend on the slots
    beside it. The train step, never vmapped, keeps cuDNN: its float32
    gradients, which the train-mode BEV BatchNorm amplifies, are held to
    the committed train record's cuDNN readings."""
    if torch.is_grad_enabled():
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=False)
