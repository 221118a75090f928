"""On-card checks: numerics of the GPU arithmetic (TF32 DEFAULT matmuls,
the GF(2) products, the HIGHEST one-hot selection, the Triton OSD
kernel) and decodes on the card, each against the CPU backend or an
exact reference (tests/gpu_checks.py).

Marked ``gpu``; the ``gpu`` fixture skips them where JAX finds no GPU.
Run on the card with:  python -m pytest -m gpu tests/test_gpu.py -v
"""

import pytest

import gpu_checks

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("check", gpu_checks.CHECKS,
                         ids=lambda c: c.__name__)
def test_gpu_check(gpu, check):
    check()
