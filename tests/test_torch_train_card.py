"""A train step of the port on the card against the same step on the CPU
(needs the card; skipped without one). The step runs the windowed engine's
gather, matmuls and scatter-add backward, train-mode BatchNorm, the losses
and one Adam update; the card has no hand kernel on this path, so the
comparison holds the CUDA route of every torch op it uses.

Tolerances: float32 losses within 1e-4 relative and gradients within 1e-3
* max(1, max|g|) (the card sums in other orders and its scatter-adds are
atomic; first card reading 2.1e-7 and 3.0e-5, NVIDIA H100 80GB HBM3, 700
W). bf16: a changed float32 sum can flip the bf16 rounding of an
activation, which every later conv reads, and this step's bf16 gradient is
itself far from its float32 one (on the CPU: a relative norm difference of
0.47, cosine 0.89, up to 100% on single BatchNorm parameters of
MotionNet), so the card's bf16 step is held to the CPU's bf16 step within
1e-2 on the losses (first reading 1.4e-3) and, on the whole gradient,
within 1.5 times the distance between the CPU's bf16 and float32
gradients (first reading 0.88 times): the card route adds no error
beyond bf16's own.

Run on the card with:
    python -m pytest --noconftest -m gpu tests/test_torch_train_card.py
(--noconftest: the repository's conftest imports jax, which the GPU
machine does not have; this file imports only the port and chip_smoke)."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import small_config
from insmos_tpu_torch.data.hdl64 import make_hdl64_window
from insmos_tpu_torch.data.sample import to_device
from insmos_tpu_torch.tools.train_record import BOXES, record_params
from insmos_tpu_torch.train.optim import make_optimizer
from insmos_tpu_torch.train.step import TrainState, make_train_step
from insmos_tpu_torch.utils.params import make_model

pytestmark = pytest.mark.gpu


def _small(dtype):
    """chip_smoke's small config (a 12.8 m range, 3 scans of 2,048
    points) in ``dtype``."""
    cfg = small_config()
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype=dtype))


def _one_step(cfg, params, state, batch, device):
    model = make_model(cfg, params, state, device)
    opt, sched = make_optimizer(model, cfg, steps_per_epoch=10)
    _, m = make_train_step(model)(TrainState(model, opt, sched),
                                  to_device(batch, device))
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    after = {n: v.cpu() for n, v in model.state_dict().items()}
    return {k: float(v) for k, v in m.items() if k != "confusion"}, grads, \
        after


def _run(dtype, device):
    cfg = _small(dtype)
    params, state = record_params(cfg)
    one = make_hdl64_window(cfg, seed=1)
    one["gt_boxes"][:len(BOXES)] = BOXES * np.float32(
        [0.3, 0.3, 1, 1, 1, 1, 1, 1])  # into the small range
    one["num_boxes"] = np.int32(len(BOXES))
    batch = {k: np.asarray(v)[None] for k, v in one.items()}
    return _one_step(cfg, params, state, batch, device)


def _flat(grads):
    return torch.cat([g.reshape(-1) for g in grads.values()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_the_card_matches_cpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from insmos_tpu_torch import setup_device

    setup_device("cuda")
    m_cpu, g_cpu, _ = _run(dtype, "cpu")
    m_gpu, g_gpu, after = _run(dtype, "cuda")
    loss_err = max(abs(m_gpu[k] - v) / max(1.0, abs(v))
                   for k, v in m_cpu.items())
    assert all(np.isfinite(v) for v in m_cpu.values())
    assert all(torch.isfinite(v).all() for v in after.values())
    if dtype == "float32":
        grad_err = max((g_gpu[n] - g).abs().max().item() / max(
            1.0, g.abs().max().item()) for n, g in g_cpu.items())
        print(f"float32: card vs CPU losses {loss_err:.3g}, gradients "
              f"{grad_err:.3g}")
        assert loss_err <= 1e-4 and grad_err <= 1e-3
        return
    _, g_cpu32, _ = _run("float32", "cpu")
    card = (_flat(g_gpu) - _flat(g_cpu)).norm().item()
    own = (_flat(g_cpu) - _flat(g_cpu32)).norm().item()
    print(f"bfloat16: card vs CPU losses {loss_err:.3g}, gradient distance "
          f"{card:.4g} beside the CPU's bf16-float32 distance {own:.4g}")
    assert loss_err <= 1e-2 and card <= 1.5 * own
