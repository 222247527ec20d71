"""Strided-conv site derivation and the inverse conv by pair replay (port
of the inference subset of insmos_tpu/sparse/convs.py).

Weight layout: (K, Cin, Cout), K enumerated x-fastest over the kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .tensor import SparseTensor
from .voxelize import unique_voxels


def _candidates(kernel_size, stride):
    per_dim = [int(math.ceil(k / s)) for k, s in zip(kernel_size, stride)]
    mesh = np.meshgrid(*[np.arange(c, dtype=np.int32) for c in per_dim][::-1],
                       indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh[::-1]], axis=-1)  # (Kc, D)


def strided_conv_sites(x: SparseTensor, kernel_size: Sequence[int],
                       stride: Sequence[int], pad: Sequence[int],
                       out_dims: Sequence[int], capacity: int,
                       with_pairs: bool = False):
    """Output site set of a strided sparse conv (every output receiving
    >= 1 contribution, deduplicated). with_pairs also returns (pairs (V, Kc)
    output row or -1, kidx (V, Kc) flat kernel position), which makes the
    exact inverse conv lookup-free."""
    dev = x.coords.device
    D = len(kernel_size)
    cand = torch.from_numpy(_candidates(kernel_size, stride)).to(dev)
    Kc = cand.shape[0]
    s = torch.tensor(stride, dtype=torch.int32, device=dev)
    p = torch.tensor(pad, dtype=torch.int32, device=dev)
    k = torch.tensor(kernel_size, dtype=torch.int32, device=dev)
    i = x.coords
    o_hi = torch.div(i + p, s, rounding_mode="floor")
    cands = o_hi[:, None, :] - cand[None]
    lo_ok = cands * s - p <= i[:, None, :]
    hi_ok = cands * s - p + (k - 1) >= i[:, None, :]
    ok = (lo_ok & hi_ok & (cands >= 0)).all(-1) & x.valid[:, None]
    sites, p2v, _, _ = unique_voxels(cands.reshape(-1, D), out_dims, capacity,
                                     point_valid=ok.reshape(-1),
                                     first_occurrence_cap=False)
    if not with_pairs:
        return sites
    pairs = torch.where(ok, p2v.reshape(-1, Kc), -1)
    delta = i[:, None, :] + p - cands * s
    kidx = torch.zeros(delta.shape[:2], dtype=torch.int32, device=dev)
    mult = 1
    for d in range(D):
        kidx = kidx + delta[..., d].clamp(0, kernel_size[d] - 1) * mult
        mult *= kernel_size[d]
    return sites, pairs, kidx


def inverse_conv_pairs(coarse: SparseTensor, weight, fine_sites: SparseTensor,
                       pairs, kidx, kernel_size, stride, pad) -> SparseTensor:
    """Exact inverse of the paired strided conv (spconv SparseInverseConv3d):
    each fine site gathers its coarse parents through the recorded pairs;
    for a candidate slot c the kernel position is a static function of the
    fine coordinate's parity, so each slot is one (V, NP*Cin) @ (NP*Cin,
    Cout) matmul. Products in float32, accumulation in float32."""
    K, cin, cout = weight.shape
    V, Kc = pairs.shape
    dev = weight.device
    D = len(stride)
    cand = _candidates(kernel_size, stride)
    assert cand.shape[0] == Kc, (cand.shape, Kc)
    NP = int(np.prod(stride))
    pars = np.stack(np.meshgrid(
        *[np.arange(s, dtype=np.int32) for s in stride][::-1], indexing="ij"
    )[::-1], axis=-1).reshape(NP, D)
    kid = np.zeros((NP, Kc), np.int64)
    mult = 1
    for d in range(D):
        delta = pars[:, None, d] + stride[d] * cand[None, :, d]
        kid += np.clip(delta, 0, kernel_size[d] - 1) * mult
        mult *= kernel_size[d]
    pmod = torch.remainder(
        fine_sites.coords + torch.tensor(pad, dtype=torch.int32, device=dev),
        torch.tensor(stride, dtype=torch.int32, device=dev))
    par = torch.zeros(V, dtype=torch.int64, device=dev)
    m = 1
    for d in range(D):
        par = par + pmod[:, d].to(torch.int64) * m
        m *= stride[d]
    sel = torch.nn.functional.one_hot(par, NP).to(torch.float32)  # (V, NP)

    feats = torch.where(coarse.valid[:, None], coarse.feats, 0.0).to(
        weight.dtype).float()
    fpad = torch.cat([feats, feats.new_zeros((1, cin))])
    w32 = weight.float()
    out = torch.zeros((V, cout), dtype=torch.float32, device=dev)
    for c in range(Kc):
        idx = torch.where(pairs[:, c] >= 0, pairs[:, c], fpad.shape[0] - 1)
        g = fpad[idx.to(torch.int64)]  # (V, cin)
        wstack = w32[torch.from_numpy(kid[:, c]).to(dev)].reshape(NP * cin,
                                                                  cout)
        gp = (g[:, None, :] * sel[:, :, None]).reshape(V, NP * cin)
        out = out + gp @ wstack
    out = out * fine_sites.valid[:, None]
    return fine_sites.replace_feats(out)
