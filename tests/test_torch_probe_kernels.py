"""The probe kernels of csrc/probe_extract.cu and csrc/probe_dot.cu against
their plain PyTorch versions (needs the card).

T10 (probe_extract): each variant at a small case (narrow widths that are
not multiples of the kernel's 64-column tile or 32-deep chunk, span 64 <
bs so out-of-window taps occur) and at the TPU probe's UNet L4 case.
Tolerance 5e-4 x max(1, max|plain|), the span kernel's: exact float32
products of bf16 operands summed in another order.
T12 (probe_dotshapes): both variants at all 12 shapes with one copy (its
reps split over the card), and with the split's edges: one rep, reps not
divisible by the split, 1, 7 and 132 copies, K and N ending inside a tile.
Each call launches once and two calls agree bit for bit. Tolerance 1e-4 x
max(1, max|plain|).

Run on the card with:
    python -m pytest --noconftest -m gpu tests/test_torch_probe_kernels.py
(--noconftest: the repository's conftest imports jax, which the GPU
machine does not have).
"""

import pytest
import torch

from insmos_tpu_torch import setup_device
from insmos_tpu_torch.tools import probe_dotshapes as PD
from insmos_tpu_torch.tools import probe_extract as PE

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return setup_device("cuda")


# name, V, TCP, TOP, span, G
EXTRACT_CASES = [
    ("small_span64", 1024, 48, 80, 64, 2),
    ("unet_l4", 24_576, 128, 128, 384, 9),
]


@pytest.mark.parametrize("case", EXTRACT_CASES,
                         ids=[c[0] for c in EXTRACT_CASES])
@pytest.mark.parametrize("variant", PE.VARIANTS)
def test_extract_kernel_matches_plain(case, variant, cuda):
    _, V, TCP, TOP, span, G = case
    args = PE.case_tensors(PE.make_case(V, TCP, TOP, span, G, 3, 128), cuda)
    before = PE.KERNEL.launches[variant]
    got = PE.extract_cuda(*args, kx=3, span=span, bs=128, variant=variant)
    torch.cuda.synchronize()
    assert PE.KERNEL.launches[variant] == before + 1
    ref = PE.extract_plain(*args, kx=3, span=span, bs=128)
    assert got.shape == ref.shape == (V, TOP) and got.dtype == torch.float32
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= PE.TOL * scale


def _check_dot(a, b, reps, variant, copies=1, splits=None):
    """One call launches once; two calls agree bit for bit; every copy is
    within TOL of the plain sum."""
    (M, _), N = a.shape, b.shape[1]
    before = PD.KERNEL.launches[variant]
    got = PD.dot_cuda(a, b, reps, variant, copies, splits)
    torch.cuda.synchronize()
    assert PD.KERNEL.launches[variant] == before + 1
    assert torch.equal(got, PD.dot_cuda(a, b, reps, variant, copies, splits))
    ref = PD.dot_plain(a, b, reps)
    assert got.shape == (copies, M, N) and got.dtype == torch.float32
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= PD.TOL * scale


@pytest.mark.parametrize("shape", PD.SHAPES, ids=[s[0] for s in PD.SHAPES])
@pytest.mark.parametrize("variant", PD.VARIANTS)
def test_dot_kernel_matches_plain(shape, variant, cuda):
    _, M, K, N, n_dots = shape
    a, b = (torch.from_numpy(x).to(cuda, torch.bfloat16)
            for x in PD.make_operands(M, K, N))
    _check_dot(a, b, PD.REP * n_dots, variant)


# name, M, K, N, reps, copies, splits (None: dot_splits for this card).
# K = 96 and 40 end inside a k-tile; N = 64 and 192 inside a 128-wide tile
COPIES_CASES = [
    ("k96_copies7", 256, 96, 128, 5, 7, None),
    ("reps1", 128, 256, 128, 1, 1, None),
    ("reps7_splits3", 128, 96, 384, 7, 1, 3),
    ("n64", 128, 96, 64, 13, 1, None),
    ("n384_copies132", 128, 256, 384, 3, 132, None),
    ("k40_n192", 128, 40, 192, 9, 1, None),
    ("m256_n384_reps64", 256, 96, 384, 64, 1, None),
]


@pytest.mark.parametrize("case", COPIES_CASES,
                         ids=[c[0] for c in COPIES_CASES])
@pytest.mark.parametrize("variant", PD.VARIANTS)
def test_dot_kernel_copies_agree(case, variant, cuda):
    _, M, K, N, reps, copies, splits = case
    a, b = (torch.from_numpy(x).to(cuda, torch.bfloat16)
            for x in PD.make_operands(M, K, N))
    _check_dot(a, b, reps, variant, copies, splits)
