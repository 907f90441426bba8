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
@pytest.mark.parametrize("D", [32, 40, 48, 64, 128])
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
@pytest.mark.parametrize("D", [1, 32, 48, 64, 128])
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


def test_ring_operand_rounds_like_the_plain_version():
    """The bf16 tile's V: the plain version's cast (round to nearest even),
    zero columns up to a whole number of tiles, the narrowest tile width
    that covers D (128 above it) unless one is asked for."""
    assert [tb.ring_tile_cols(D) for D in (8, 24, 40, 48, 56, 128, 136)] == \
        [8, 32, 48, 48, 64, 128, 128]
    rng = np.random.default_rng(0)
    for D, cols, want in ((48, None, (48, 48)), (40, None, (48, 48)),
                          (136, None, (128, 256)), (128, 64, (64, 128))):
        V = torch.from_numpy(rng.standard_normal((16, D)).astype(np.float32))
        got_cols, Vb = tb.ring_operand(V, cols)
        assert (got_cols, Vb.shape[1]) == want and Vb.dtype == torch.bfloat16
        assert torch.equal(Vb[:, :D], V.to(torch.bfloat16))
        assert not Vb[:, D:].any()
    with pytest.raises(ValueError, match="tile_cols"):
        tb.ring_operand(torch.zeros((16, 48)), 40)


def _edge_operand():
    """K=640 with the rows the bf16 tile treats apart: block-row 0 holds
    column-blocks 0 and 2 (its first real block is column-block 0), 1 is
    empty, 2 holds 1..4 (no padding at maxblk 4 or G 4), 3 holds 3, 4 holds
    0 and 4."""
    rng = np.random.default_rng(3)
    rows, cols = [], []
    for br, bcs in {0: [0, 2], 2: [1, 2, 3, 4], 3: [3], 4: [0, 4]}.items():
        for bc in bcs:
            rows.append(br * 128 + rng.integers(0, 128, 300))
            cols.append(bc * 128 + rng.integers(0, 128, 300))
    r, c = np.concatenate(rows), np.concatenate(cols)
    return scipy.sparse.csr_matrix((rng.standard_normal(r.size), (r, c)),
                                   shape=(640, 640))


def _edge_case(kind, dt):
    M = _edge_operand()
    if kind == "ell":
        mat = tb.bcsr_from_csr(M, block=128, dtype=dt, device="cuda")
        assert mat.bcols.shape[1] == 4
        return mat, tb.bcsr_spmm, tb.bcsr_spmm_reference
    mat = tb.bsr_flat_from_csr(M, block=128, group=4, dtype=dt, device="cuda")
    return mat, tb.bsr_spmm_flat, tb.bsr_spmm_flat_reference


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ell", "flat"])
@pytest.mark.parametrize("D", [8, 48, 128])
def test_kernels_on_edge_rows_on_cuda(D, kind, dt):
    """An empty block-row (zero output), a row whose first real block is
    column-block 0 and a row with no padding, through both kernels, against
    the plain version (which multiplies every slot) to 1e-5 of max|out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mat, kernel, plain = _edge_case(kind, getattr(torch, dt))
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    got, want = kernel(mat, V), plain(mat, V)
    assert not got[128:256].any()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ell", "flat", "flat-split"])
@pytest.mark.parametrize("D", [48, 128])
def test_bf16_tile_is_deterministic_on_cuda(D, kind):
    """Repeat launches of the bf16 ring tile are bitwise equal (one CTA
    owns each output tile and sums its slots in a fixed order), also with
    D split over several CTAs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    St = build_st_csr(S, Q)
    V = torch.randn((384, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2))
    if kind == "ell":
        mat = tb.bcsr_from_csr(St, block=128, dtype=torch.bfloat16,
                               device="cuda")
        run = lambda: tb.bcsr_spmm(mat, V)   # noqa: E731
    else:
        mat = tb.bsr_flat_from_csr(St, block=128, group=8,
                                   dtype=torch.bfloat16, device="cuda")
        cols = {48: 16, 128: 64}[D] if kind == "flat-split" else None
        run = lambda: tb.bsr_spmm_flat(mat, V, tile_cols=cols)   # noqa: E731
    a, b = run(), run()
    assert torch.equal(a, b)
    want = (tb.bcsr_spmm_reference(mat, V) if kind == "ell"
            else tb.bsr_spmm_flat_reference(mat, V))
    assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())
