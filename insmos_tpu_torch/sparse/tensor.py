"""Fixed-capacity sparse voxel tensor (port of insmos_tpu/sparse/tensor.py).

Sites are stored in ascending linearized-key order; padding rows carry
KEY_SENTINEL, sort last, and have ``valid == False``, so valid rows are a
prefix. A SparseTensor is a pytree (its tensors the leaves, ``dims`` static),
so a function under ``torch.func.vmap`` can return one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils import _pytree

KEY_SENTINEL = 2**31 - 1  # int32 max


@dataclass
class SparseTensor:
    coords: torch.Tensor  # (V, D) int32
    keys: torch.Tensor  # (V,) int32 ascending, sentinel padding
    feats: torch.Tensor  # (V, C)
    valid: torch.Tensor  # (V,) bool
    dims: tuple

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_features(self) -> int:
        return self.feats.shape[-1]

    def replace_feats(self, feats) -> "SparseTensor":
        return SparseTensor(self.coords, self.keys, feats, self.valid, self.dims)

    def masked_feats(self) -> torch.Tensor:
        return torch.where(self.valid[:, None], self.feats, 0.0)

    def sites(self) -> "SparseTensor":
        return SparseTensor(
            self.coords, self.keys, self.feats.new_zeros((self.capacity, 0)),
            self.valid, self.dims,
        )


_pytree.register_pytree_node(
    SparseTensor,
    lambda x: ((x.coords, x.keys, x.feats, x.valid), x.dims),
    lambda leaves, dims: SparseTensor(*leaves, dims),
)
