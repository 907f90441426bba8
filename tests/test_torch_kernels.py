"""The flat block-CSR SpMM kernel wrapper (sig_sdp_mmw_torch.ops.bcsr):
what its CUDA path refuses, and the kernel against its plain version.

This file imports no jax, so the ``cuda``-marked tests also run on a CUDA
machine without it (the suite's conftest imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_torch.core.ell import build_st_csr
from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.ops import bcsr as tb


@pytest.fixture(scope="module")
def rand512():
    return scipy.sparse.random(512, 512, density=0.05, random_state=0,
                               format="csr")


def test_flat_kernel_refuses_what_it_cannot_take(rand512):
    """The CUDA path's operand checks (device-independent part) and its
    refusal of a device that has no kernel."""
    sq = tb.bsr_flat_from_csr(rand512, block=128, group=4)
    V = torch.zeros((512, 32))
    assert tb.flat_kernel_unsupported(sq, V) is None
    narrow = tb.bsr_flat_from_csr(rand512, block=(8, 128), group=4)
    assert "128x128" in tb.flat_kernel_unsupported(narrow, V)
    f64 = tb.bsr_flat_from_csr(rand512, block=128, group=4,
                               dtype=torch.float64)
    assert "float32 or bfloat16" in tb.flat_kernel_unsupported(f64, V)
    assert "V must be float32" in tb.flat_kernel_unsupported(sq, V.double())
    assert "multiple of 8" in tb.flat_kernel_unsupported(
        sq, torch.zeros((512, 12)))
    assert "contiguous" in tb.flat_kernel_unsupported(
        sq, torch.zeros((32, 512)).T)
    assert "V must be [512, D]" in tb.flat_kernel_unsupported(
        sq, torch.zeros((384, 32)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tb.bsr_spmm_flat(sq, torch.zeros((512, 32), device="meta"))
    with pytest.raises(ValueError, match="sorted by block-row"):
        tb.flat_bsr(np.array([1, 0], np.int32), np.zeros(8, np.int32),
                    sq.blocks[:2], 256)
    with pytest.raises(ValueError, match="at least one step"):
        tb.flat_bsr(np.array([0, 0], np.int32), np.zeros(8, np.int32),
                    sq.blocks[:2], 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 40, 128])
def test_flat_kernel_matches_reference_on_cuda(D, dt):
    """The CUDA kernel vs its plain version on the card: the same rounded
    products summed in float32 in another order, to 1e-5 of max|out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    mat = tb.bsr_flat_from_csr(build_st_csr(S, Q), block=128, group=8,
                               dtype=getattr(torch, dt), device="cuda")
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    n0 = tb.bsr_spmm_flat.launches
    got = tb.bsr_spmm_flat(mat, V)
    assert tb.bsr_spmm_flat.launches == n0 + 1
    want = tb.bsr_spmm_flat_reference(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
