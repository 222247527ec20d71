"""InsMOS in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``insmos_tpu`` (kept beside it as the
reference). Module layout and function names follow ``insmos_tpu`` one to
one, so every counterpart is found at the same path. The jax-free modules
of the reference (``insmos_tpu.config``, ``insmos_tpu.constants``,
``insmos_tpu.data.hdl64``, ``insmos_tpu.data.sample``) are imported, not
copied; nothing here imports jax.
"""

from __future__ import annotations

import torch


def setup_device(device) -> torch.device:
    """Resolve ``device`` and pin float32 numerics.

    TF32 is turned off for both matmuls and cuDNN convolutions: the port
    accumulates in float32 everywhere (bf16 operands where the config asks
    for them), and the BEV backbone's convolutions would otherwise run in
    TF32 on the card by default and drift from the reference by ~1e-3.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device)
