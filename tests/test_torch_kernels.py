"""The SpMM kernel wrappers of sig_sdp_mmw_torch.ops.bcsr (flat block-CSR,
block-ELL, flat with V resident): what their CUDA paths refuse, and each
kernel against its plain version.

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


def test_ell_kernel_refuses_what_it_cannot_take(rand512):
    """The block-ELL CUDA path's operand checks (device-independent part),
    its refusal of a device that has no kernel, and that the CPU path is
    the plain version."""
    sq = tb.bcsr_from_csr(rand512, block=128)
    V = torch.zeros((512, 32))
    assert tb.ell_kernel_unsupported(sq, V) is None
    assert tb.ell_kernel_unsupported(tb.bcsr_from_csr(rand512, block=(8, 128)),
                                     V) is None
    odd = tb.bcsr_from_csr(rand512, block=(16, 128))
    assert "128x128 or 8x128" in tb.ell_kernel_unsupported(odd, V)
    narrow = tb.bcsr_from_csr(rand512, block=64)
    assert "128x128 or 8x128" in tb.ell_kernel_unsupported(narrow, V)
    f64 = tb.bcsr_from_csr(rand512, block=128, dtype=torch.float64)
    assert "float32 or bfloat16" in tb.ell_kernel_unsupported(f64, V)
    assert "V must be float32" in tb.ell_kernel_unsupported(sq, V.double())
    assert "multiple of 8" in tb.ell_kernel_unsupported(
        sq, torch.zeros((512, 12)))
    assert "contiguous" in tb.ell_kernel_unsupported(
        sq, torch.zeros((32, 512)).T)
    assert "V must be [512, D]" in tb.ell_kernel_unsupported(
        sq, torch.zeros((384, 32)))
    long_bcols = tb.BlockEll(bcols=sq.bcols.long(), blocks=sq.blocks,
                             nrows=sq.nrows)
    assert "int32" in tb.ell_kernel_unsupported(long_bcols, V)
    torn = tb.BlockEll(bcols=sq.bcols, blocks=sq.blocks[:2], nrows=sq.nrows)
    assert "do not match" in tb.ell_kernel_unsupported(torn, V)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tb.bcsr_spmm(sq, torch.zeros((512, 32), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tb.bsr_spmm_vres(tb.bsr_flat_from_csr(rand512, block=128, group=4),
                         torch.zeros((512, 32), device="meta"))
    n0 = tb.bcsr_spmm.launches
    Vr = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (512, 3)).astype(np.float32))
    np.testing.assert_array_equal(tb.bcsr_spmm(sq, Vr).numpy(),
                                  tb.bcsr_spmm_reference(sq, Vr).numpy())
    assert tb.bcsr_spmm.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("brow", [128, 8])
@pytest.mark.parametrize("D", [1, 48, 128])
def test_ell_kernel_matches_reference_on_cuda(D, brow, dt):
    """The block-ELL CUDA kernel vs its plain version on the card, at both
    block heights; D=1 (the gap Lanczos) goes through the zero-padded
    columns.  To 1e-5 of max|out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    mat = tb.bcsr_from_csr(build_st_csr(S, Q), block=(brow, 128),
                           dtype=getattr(torch, dt), device="cuda")
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    n0 = tb.bcsr_spmm.launches
    got = tb.bcsr_spmm(mat, V)
    assert tb.bcsr_spmm.launches == n0 + 1 and got.shape == (mat.nrows, D)
    want = tb.bcsr_spmm_reference(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [4, 8, 16, 32])
def test_vres_kernel_matches_reference_on_cuda(G, dt):
    """The V-resident flat kernel vs the flat plain version on the card,
    at every group the bench runs (G=16, 32 stage V in chunks).  To 1e-5 of
    max|out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    mat = tb.bsr_flat_from_csr(build_st_csr(S, Q), block=128, group=G,
                               dtype=getattr(torch, dt), device="cuda")
    V = torch.randn((mat.nrows, 48), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    n0 = tb.bsr_spmm_vres.launches
    got = tb.bsr_spmm_vres(mat, V)
    assert tb.bsr_spmm_vres.launches == n0 + 1
    want = tb.bsr_spmm_flat_reference(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
