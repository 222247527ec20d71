"""InsMOS in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``insmos_tpu`` (kept beside it as the
reference). Module layout and function names follow ``insmos_tpu`` one to
one, so every counterpart is found at the same path. The port imports
nothing of ``insmos_tpu`` and no jax: what it needs of the reference's
jax-free modules it keeps as its own copies (``config``, ``data.hdl64``).
Its entry points run on the card unless the caller asks for the CPU.
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
