"""The SpMM kernel wrappers of sig_sdp_mmw_torch.ops.bcsr (flat block-CSR,
block-ELL, flat with V resident): what their CUDA paths refuse, and each
kernel against its plain version.

This file imports no jax, so the ``cuda``-marked tests also run on a CUDA
machine without it (the suite's conftest imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_torch.core.ell import build_st_csr
from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.experiments.bench_vres_parts import longest_first
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
    for block in ((8, 128), (16, 128), 64, 16):   # the short-block tile's shapes
        other = tb.bsr_flat_from_csr(rand512, block=block, group=4)
        assert tb.flat_kernel_unsupported(other, V) is None
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
    long_bcols = dataclasses.replace(sq, bcols=sq.bcols.long())
    assert "bcols must be torch.int32" in tb.flat_kernel_unsupported(
        long_bcols, V)
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
@pytest.mark.parametrize("D", [1, 20, 32, 40, 48, 64, 128])
def test_flat_kernel_matches_reference_on_cuda(D, dt):
    """The CUDA kernel vs its plain version on the card: the same rounded
    products summed in float32 in another order, to 1e-5 of max|out|; D=1
    (the gap Lanczos) and D=20 through the zero-padded columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    mat = tb.bsr_flat_from_csr(build_st_csr(S, Q), block=128, group=8,
                               dtype=getattr(torch, dt), device="cuda")
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    n0 = tb.bsr_spmm_flat.launches
    got = tb.bsr_spmm_flat(mat, V)
    assert tb.bsr_spmm_flat.launches == n0 + 1 and got.shape == (mat.nrows, D)
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
    for block in ((16, 128), 64, 16, (32, 64)):   # the short-block tile's shapes
        other = tb.bcsr_from_csr(rand512, block=block)
        assert tb.ell_kernel_unsupported(other, V) is None
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
@pytest.mark.parametrize("D", [1, 8, 20, 48, 128, 200])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 16, 32])
def test_vres_kernel_matches_reference_on_cuda(G, D, dt):
    """The V-resident flat kernel vs the flat plain version on the card, at
    groups from 1 to 32 (G=32 pads every row to 32 slots) and D from 1 to
    200 (the bf16 kernel's tile widths 16, 32, 64 and 128, the float32
    one's 16, 32, 48, 64, 96 and 128; D=200 as two 128-column tiles, the
    second part-full), to 1e-5 of max|out|; two launches bitwise equal,
    both counted on the dtype's 128x128 route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    mat = tb.bsr_flat_from_csr(build_st_csr(S, Q), block=128, group=G,
                               dtype=getattr(torch, dt), device="cuda")
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    n0, g0 = tb.bsr_spmm_vres.launches, tb.bsr_spmm_vres.generic_launches
    got = tb.bsr_spmm_vres(mat, V)
    assert torch.equal(got, tb.bsr_spmm_vres(mat, V))
    assert tb.bsr_spmm_vres.launches == n0 + 2 and got.shape == (mat.nrows, D)
    # Both launches on the 128x128 route of their dtype, none generic.
    assert tb.spmm_route("vres", 128, 128, mat.blocks.dtype) == (
        "tma_f32" if dt == "float32" else "ring")
    assert tb.bsr_spmm_vres.generic_launches == g0
    want = tb.bsr_spmm_flat_reference(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("D", [1, 20])
def test_flat_wrappers_pad_any_D(rand512, D):
    """The flat and V-resident wrappers take any D: the kernels' checks
    refuse D=1 and D=20 as they are and accept them padded with zero columns
    to a multiple of 8; the bf16 V copy of the V-resident kernel is the
    plain version's cast of the padded V.  The CPU path keeps D."""
    mat = tb.bsr_flat_from_csr(rand512, block=128, group=4)
    V = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (512, D)).astype(np.float32))
    assert "multiple of 8" in tb.flat_kernel_unsupported(mat, V)
    Vk = tb.pad_columns(V)
    assert Vk.shape == (512, -(-D // 8) * 8) and Vk.is_contiguous()
    assert torch.equal(Vk[:, :D], V) and not Vk[:, D:].any()
    assert tb.flat_kernel_unsupported(mat, Vk) is None
    assert torch.equal(tb.vres_operand(Vk), Vk.to(torch.bfloat16))
    for fn in (tb.bsr_spmm_flat, tb.bsr_spmm_vres):
        assert fn(mat, V).shape == (512, D)


def test_vres_operand_widths():
    """The V-resident kernel's bf16 V: D columns up to 128 (the kernel's
    loads fill a tile's rest with zeros), a multiple of 128 above, zeros
    past D."""
    rng = np.random.default_rng(0)
    for D, ldv in ((8, 8), (48, 48), (128, 128), (136, 256), (256, 256)):
        V = torch.from_numpy(rng.standard_normal((16, D)).astype(np.float32))
        Vb = tb.vres_operand(V)
        assert Vb.shape == (16, ldv) and Vb.dtype == torch.bfloat16
        assert torch.equal(Vb[:, :D], V.to(torch.bfloat16))
        assert not Vb[:, D:].any()


def _real_blocks_per_row(M, Kbr):
    """Distinct column-blocks of each block-row's entries (0 for an empty
    row)."""
    coo = M.tocoo()
    pairs = np.unique((coo.row // 128).astype(np.int64) * Kbr
                      + coo.col // 128)
    return np.bincount(pairs // Kbr, minlength=Kbr)


@pytest.mark.parametrize("G", [1, 3, 8, 32])
@pytest.mark.parametrize("which", ["edge", "banded"])
def test_longest_first_renumbers_block_rows(which, G):
    """The V-resident parts bench's longest-first operand: its block-rows
    are a permutation of the operand's, their real-block counts (counted
    here from the CSR) non-increasing, ties in index order, and its product
    is the operand's with the output row-blocks permuted."""
    M = _edge_operand() if which == "edge" else _banded_operand(40)
    mat = tb.bsr_flat_from_csr(M, block=128, group=G)
    sorted_mat, perm = longest_first(mat)
    perm = perm.numpy()
    assert np.array_equal(np.sort(perm), np.arange(mat.Kbr))
    c = _real_blocks_per_row(M, mat.Kbr)[perm]
    assert np.all(np.diff(c) <= 0)
    assert all(np.all(np.diff(perm[c == k]) > 0) for k in np.unique(c))
    assert (sorted_mat.nsteps, sorted_mat.G) == (mat.nsteps, G)
    V = torch.from_numpy(np.random.default_rng(G).standard_normal(
        (mat.nrows, 8)).astype(np.float32))
    want = tb.bsr_spmm_flat_reference(mat, V).reshape(mat.Kbr, 128, 8)[perm]
    got = tb.bsr_spmm_flat_reference(sorted_mat, V).reshape(mat.Kbr, 128, 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


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


def _banded_operand(Kbr, seed=4):
    """K = 128*Kbr, banded: block-row r holds column-blocks r-1, r, r+1 and
    one more within 8, except row 0, which holds column-blocks 0..11 (its
    first real block is column-block 0, and it is longer than any ring of
    the V-resident kernel), and row 1, which is empty."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for br in range(Kbr):
        if br == 1:
            continue
        bcs = (range(12) if br == 0 else
               {c % Kbr for c in (br - 1, br, br + 1, br + rng.integers(2, 9))})
        for bc in bcs:
            rows.append(br * 128 + rng.integers(0, 128, 40))
            cols.append(bc * 128 + rng.integers(0, 128, 40))
    r, c = np.concatenate(rows), np.concatenate(cols)
    return scipy.sparse.csr_matrix((rng.standard_normal(r.size), (r, c)),
                                   shape=(128 * Kbr, 128 * Kbr))


def _edge_case(kind, dt):
    M = _edge_operand()
    if kind == "ell":
        mat = tb.bcsr_from_csr(M, block=128, dtype=dt, device="cuda")
        assert mat.bcols.shape[1] == 4
        return mat, tb.bcsr_spmm, tb.bcsr_spmm_reference
    mat = tb.bsr_flat_from_csr(M, block=128, group=4, dtype=dt, device="cuda")
    kernel = tb.bsr_spmm_vres if kind == "vres" else tb.bsr_spmm_flat
    return mat, kernel, tb.bsr_spmm_flat_reference


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ell", "flat", "vres"])
@pytest.mark.parametrize("D", [1, 8, 32, 48, 128, 200])
def test_kernels_on_edge_rows_on_cuda(D, kind, dt):
    """An empty block-row (zero output), a row whose first real block is
    column-block 0 and a row with no padding, through the three kernels
    (5 block-rows: fewer than the V-resident kernel's persistent CTAs), at
    D from 1 (padded to 8) to 200 (two 128-column tiles, the second
    part-full), against the plain version (which multiplies every slot) to
    1e-5 of max|out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mat, kernel, plain = _edge_case(kind, getattr(torch, dt))
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    got, want = kernel(mat, V), plain(mat, V)
    assert not got[128:256].any()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# The tiles whose repeat launches must agree bit for bit, in bfloat16 and
# float32: the ring tile (block-ELL, flat, flat with D over two CTAs) and
# the short-block tile (block-ELL at the packers' default 8x128, flat at the
# mid-K search's 32x32 and at 8x8, V-resident at 8x128).
BF16_TILE_CASES = {"ell": ("ell", 128), "flat": ("flat", 128),
                   "flat-split": ("flat", 128),
                   "short-ell-8x128": ("ell", (8, 128)),
                   "short-flat-32x32": ("flat", 32),
                   "short-flat-8x8": ("flat", 8),
                   "short-vres-8x128": ("vres", (8, 128))}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(BF16_TILE_CASES))
@pytest.mark.parametrize("D", [48, 128])
def test_bf16_tile_is_deterministic_on_cuda(D, kind, dt):
    """Repeat launches of the ring and short-block tiles, bfloat16 and
    float32, are bitwise equal (one CTA or warp owns each output tile and
    sums its slots in a fixed order, no atomics), also with D split over
    several CTAs; each agrees with its plain version to 1e-5 of max|out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    St = build_st_csr(S, Q)
    which, block = BF16_TILE_CASES[kind]
    dtype = getattr(torch, dt)
    if which == "ell":
        mat = tb.bcsr_from_csr(St, block=block, dtype=dtype, device="cuda")
        fn, plain = tb.bcsr_spmm, tb.bcsr_spmm_reference
    else:
        mat = tb.bsr_flat_from_csr(St, block=block, group=8, dtype=dtype,
                                   device="cuda")
        fn = tb.bsr_spmm_vres if which == "vres" else tb.bsr_spmm_flat
        plain = tb.bsr_spmm_flat_reference
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2))
    if kind == "flat-split":
        cols = {48: 16, 128: 64}[D]
        run = lambda: tb.bsr_spmm_flat(mat, V, tile_cols=cols)   # noqa: E731
    else:
        run = lambda: fn(mat, V)   # noqa: E731
    g0 = fn.generic_launches
    a, b = run(), run()
    assert torch.equal(a, b)
    assert fn.generic_launches == g0 + (2 if kind.startswith("short") else 0)
    want = plain(mat, V)
    assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [20, 128])
@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("Kbr", [20, 300])
def test_vres_kernel_on_long_and_many_rows_on_cuda(Kbr, G, D, dt):
    """The V-resident kernel on a banded operand with a row of 12 real
    blocks (longer than the ring, its first at column-block 0) and an empty
    row, with fewer (20) and more (300) block-rows than persistent CTAs:
    against the plain version to 1e-5 of max|out|, two launches bitwise
    equal, the empty row zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mat = tb.bsr_flat_from_csr(_banded_operand(Kbr), block=128, group=G,
                               dtype=getattr(torch, dt), device="cuda")
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    got = tb.bsr_spmm_vres(mat, V)
    assert torch.equal(got, tb.bsr_spmm_vres(mat, V))
    assert not got[128:256].any()
    want = tb.bsr_spmm_flat_reference(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# Block shapes without a 128x128 fast path: Br in 8..128 by Bc in 16..128,
# the square 8/16/32/64 blocks (8x8 is the graft entry's), a block taller
# than 128 rows (split into row slices) and a shape whose Bc is not a
# multiple of the slice depth nor of 16 (the short tile's zero tail).
GENERIC_SHAPES = [(8, 128), (16, 128), (32, 128), (64, 128), (8, 16),
                  (16, 16), (32, 32), (64, 64), (128, 16), (16, 64),
                  (256, 32), (24, 40), (8, 8)]


def _generic_case(kind, block, dt, G=4):
    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    St = build_st_csr(S, Q)
    if kind == "ell":
        mat = tb.bcsr_from_csr(St, block=block, dtype=dt, device="cuda")
        return mat, tb.bcsr_spmm, tb.bcsr_spmm_reference
    mat = tb.bsr_flat_from_csr(St, block=block, group=G, dtype=dt,
                               device="cuda")
    kernel = tb.bsr_spmm_vres if kind == "vres" else tb.bsr_spmm_flat
    return mat, kernel, tb.bsr_spmm_flat_reference


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 20, 48, 128, 200])
@pytest.mark.parametrize("block", GENERIC_SHAPES,
                         ids=[f"{a}x{b}" for a, b in GENERIC_SHAPES])
@pytest.mark.parametrize("kind", ["flat", "ell", "vres"])
def test_generic_tile_matches_reference_on_cuda(kind, block, D, dt):
    """The short-block tile (bfloat16 and float32) of the three kernels
    against their plain versions on the card, at every block shape without
    a 128x128 fast path and D from 1 to 200 (two 128-column tiles): to 1e-5
    of max|out|, two launches bitwise equal, counted as generic launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mat, kernel, plain = _generic_case(kind, block, getattr(torch, dt))
    V = torch.randn((mat.nrows, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    n0, g0 = kernel.launches, kernel.generic_launches
    got = kernel(mat, V)
    assert torch.equal(got, kernel(mat, V)) and got.shape == (mat.nrows, D)
    assert kernel.launches == n0 + 2
    route = tb.spmm_route(kind, *block, getattr(torch, dt))
    assert route == ("short_bf16" if dt == "bfloat16" else "short_f32")
    assert kernel.generic_launches == g0 + 2
    want = plain(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _long_operand(K, seed=5):
    """K x K banded CSR, three entries per row near the diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(K), 3)
    cols = np.clip(rows + rng.integers(-40, 41, rows.size), 0, K - 1)
    return scipy.sparse.csr_matrix((rng.standard_normal(rows.size),
                                    (rows, cols)), shape=(K, K))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["flat", "vres", "ell"])
def test_generic_tile_takes_more_than_65535_block_rows_on_cuda(kind, dt):
    """8-row blocks of a K = 600,000 operand: 75,000 block-rows, past the
    65,535 a grid's second dimension holds; against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M = _long_operand(600_000)
    dtype = getattr(torch, dt)
    if kind == "ell":
        mat = tb.bcsr_from_csr(M, block=(8, 128), dtype=dtype, device="cuda")
        kernel, plain = tb.bcsr_spmm, tb.bcsr_spmm_reference
        assert mat.Kb > 65535
    else:
        mat = tb.bsr_flat_from_csr(M, block=(8, 128), group=2, dtype=dtype,
                                   device="cuda")
        kernel = tb.bsr_spmm_vres if kind == "vres" else tb.bsr_spmm_flat
        plain = tb.bsr_spmm_flat_reference
        assert mat.Kbr > 65535
    V = torch.randn((mat.nrows, 48), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    got, want = kernel(mat, V), plain(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


ROUTE_SHAPES = [(128, 128), *GENERIC_SHAPES]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["flat", "ell", "vres"])
def test_spmm_route_names_one_body_per_shape(kind, dt):
    """spmm_route: 128x128 takes the ring tile, in bfloat16 on every kernel
    and in float32 on the flat and block-ELL kernels (the V-resident
    kernel takes its TMA ring with three tf32 products per pair,
    "tma_f32"); every other shape the short-block tile, in either dtype.
    Only the short-block routes count as generic launches; other kinds and
    dtypes are refused."""
    dtype = getattr(torch, dt)
    for block in ROUTE_SHAPES:
        route = tb.spmm_route(kind, *block, dtype)
        if block == (128, 128):
            want = ("ring" if dt == "bfloat16" else
                    "tma_f32" if kind == "vres" else "ring_f32")
        else:
            want = "short_bf16" if dt == "bfloat16" else "short_f32"
        assert route == want, (kind, block, dt)
        assert (route in tb.GENERIC_ROUTES) == (want in ("short_bf16",
                                                         "short_f32"))
    with pytest.raises(ValueError, match="kind"):
        tb.spmm_route("dense", 8, 128, dtype)
    with pytest.raises(ValueError, match="float64"):
        tb.spmm_route(kind, 8, 128, torch.float64)


# Float32 bit patterns and their TF32 rounding as cvt.rna.tf32.f32 gives it
# (to nearest, ties away from zero, 10 explicit mantissa bits kept).
TF32_ROUNDING = [
    (0x3F800000, 0x3F800000),   # 1: already TF32
    (0x3F801000, 0x3F802000),   # 1 + 2^-11, a tie above an even value: up
    (0xBF801000, 0xBF802000),   # its negative: away from zero, down
    (0x3F800FFF, 0x3F800000),   # just below that tie
    (0x3F801001, 0x3F802000),   # just above it
    (0x3F803000, 0x3F804000),   # a tie above an odd value
    (0x3FFFF000, 0x40000000),   # 2 - 2^-11: the carry moves the exponent
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x80000000, 0x80000000),   # -0
    (0x7F800000, 0x7F800000),   # inf
    (0x7FC00001, 0x7FC00001),   # a NaN passes through
]


@pytest.mark.parametrize("bits,want", TF32_ROUNDING,
                         ids=[f"{b:08x}" for b, _ in TF32_ROUNDING])
def test_tf32_round_is_cvt_rna(bits, want):
    """The model of the float32 tiles' split: round to nearest with ties
    away from zero (not to even), the low 13 bits zero for every finite
    value, non-finite values unchanged."""
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    got = int(tb.tf32_round(x).view(torch.int32)[0]) & 0xFFFFFFFF
    assert got == want
    if bool(torch.isfinite(x)):
        assert got & 0x1FFF == 0


def _spread_operands(seed, D):
    """rand512's pattern with values of random sign whose magnitudes spread
    log-uniformly over 1e-6..1e2, and a [512, D] V spread alike."""
    rng = np.random.default_rng(seed)
    M = scipy.sparse.random(512, 512, density=0.05, random_state=seed,
                            format="csr")
    M.data = rng.choice([-1.0, 1.0], M.nnz) * 10 ** rng.uniform(-6, 2, M.nnz)
    V = rng.choice([-1.0, 1.0], (512, D)) * 10 ** rng.uniform(-6, 2, (512, D))
    return (torch.from_numpy(M.toarray().astype(np.float32)),
            torch.from_numpy(V.astype(np.float32)))


@pytest.mark.parametrize("seed,D", [(0, 1), (1, 8), (2, 48), (3, 128)])
def test_tf32_split_product_keeps_float32_accuracy(seed, D):
    """Three tf32 products per pair (the float32 tiles' arithmetic) over
    operands spread across eight decades: within 1e-6 of max|out| of the
    float64 product (each pair's error is below 3 * 2^-22 of |a*b|) and
    within 1e-5, the kernel tests' tolerance, of the plain float32 product."""
    A, V = _spread_operands(seed, D)
    got = tb.tf32_split_matmul(A, V)
    exact = A.double() @ V.double()
    scale = float(exact.abs().max())
    assert float((got.double() - exact).abs().max()) <= 1e-6 * scale
    plain = A @ V
    assert float((got - plain).abs().max()) <= 1e-5 * float(
        plain.abs().max())


@pytest.mark.parametrize("seed,D", [(0, 1), (1, 8), (2, 48), (3, 128)])
def test_single_tf32_product_misses_the_kernel_tolerance(seed, D):
    """One tf32 product per pair keeps 11 bits of each operand: on the same
    operands it misses the kernels' 1e-5 of max|out| against the plain
    float32 product, which is why the float32 tiles take three."""
    A, V = _spread_operands(seed, D)
    one = tb.tf32_round(A) @ tb.tf32_round(V)
    plain = A @ V
    assert float((one - plain).abs().max()) > 1e-5 * float(
        plain.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "ell", "vres"])
@pytest.mark.parametrize("block", [128, (8, 128), 8],
                         ids=["128x128", "8x128", "8x8"])
@pytest.mark.parametrize("D", [8, 48, 128])
def test_float32_tiles_keep_float32_accuracy_on_cuda(D, block, kind):
    """Float32 blocks and V spread over eight decades (1e-6..1e2, random
    signs) through the float32 ring and short-block tiles and the
    V-resident kernel's TMA body: within 1e-6 of max|out| of the float64
    product, as the CPU model of the split is, and within 1e-5 of the plain
    float32 version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    M = build_st_csr(*generate_large_state_csr(10, 75e-4, seed=2)[:2])
    M.data = rng.choice([-1.0, 1.0], M.nnz) * 10 ** rng.uniform(-6, 2, M.nnz)
    if kind == "ell":
        mat = tb.bcsr_from_csr(M, block=block, device="cuda")
        kernel, plain = tb.bcsr_spmm, tb.bcsr_spmm_reference
    else:
        mat = tb.bsr_flat_from_csr(M, block=block, group=8, device="cuda")
        kernel = tb.bsr_spmm_vres if kind == "vres" else tb.bsr_spmm_flat
        plain = tb.bsr_spmm_flat_reference
    V = torch.from_numpy((rng.choice([-1.0, 1.0], (mat.nrows, D)) * 10
                          ** rng.uniform(-6, 2, (mat.nrows, D))
                          ).astype(np.float32)).to("cuda")
    got = kernel(mat, V)
    exact = plain(mat, V.double())
    scale = float(exact.abs().max())
    assert float((got.double() - exact).abs().max()) <= 1e-6 * scale
    want = plain(mat, V)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_short_operand_rounds_like_the_plain_version():
    """The short-block tile's V: the plain version's cast to bfloat16
    (round to nearest even, ties included), zero columns up to a whole
    number of warp tiles of 16..128 columns (128 above 128)."""
    assert [tb.short_tile_cols(D) for D in (8, 16, 24, 40, 48, 56, 72, 96,
                                            104, 128, 136, 200)] == \
        [16, 16, 32, 48, 48, 64, 96, 96, 128, 128, 128, 128]
    rng = np.random.default_rng(7)
    for D, ldv in ((8, 16), (24, 32), (48, 48), (64, 64), (200, 256)):
        V = rng.standard_normal((40, D)).astype(np.float32)
        # Values half-way between two bfloat16 numbers round to even.
        V[0, :4] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                             2 ** -130], np.float32)
        Vt = torch.from_numpy(V)
        cols, Vb = tb.short_operand(tb.pad_columns(Vt))
        assert cols == tb.short_tile_cols(D) and Vb.shape == (40, ldv)
        assert Vb.dtype == torch.bfloat16
        assert torch.equal(Vb[:, :D], Vt.to(torch.bfloat16))
        assert not Vb[:, D:].any()
        assert Vb[0, :3].float().tolist() == [1.0, 1 + 2 ** -6, -1.0]


@pytest.mark.parametrize("kind,block", [("flat", (8, 128)),
                                        ("ell", (16, 128)),
                                        ("flat", (8, 8)), ("ell", (24, 40))])
def test_library_csr_operand_holds_the_real_blocks(kind, block):
    """The yardstick's CSR operand (for block shapes the BSR product
    refuses): every entry of every real block, zeros inside a block
    included, at its place, so its product is the plain version's; padding
    slots and empty block-rows add nothing."""
    from sig_sdp_mmw_torch.experiments.bench_flat_spmm import (
        library_csr_operand, real_slots)

    M = _edge_operand()
    if kind == "ell":
        mat = tb.bcsr_from_csr(M, block=block)
        plain = tb.bcsr_spmm_reference
    else:
        mat = tb.bsr_flat_from_csr(M, block=block, group=4)
        plain = tb.bsr_spmm_flat_reference
    A = library_csr_operand(mat, torch.float32)
    Br, Bc = block
    assert A._nnz() == int(real_slots(mat).sum()) * Br * Bc
    dense = np.zeros((mat.nrows, mat.nrows))
    dense[:640, :640] = M.toarray()
    np.testing.assert_allclose(A.to_dense().numpy(), dense, rtol=1e-6,
                               atol=1e-7)
    V = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (mat.nrows, 5)).astype(np.float32))
    np.testing.assert_allclose((A @ V).numpy(), plain(mat, V).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_kernels_refuse_2_31_slots():
    """The kernels index block slots in 32 bits: an operand with 2^31 or
    more slots is refused by name (shapes on the meta device: nothing is
    allocated but V)."""
    Kb, maxblk = 2 ** 20, 2 ** 11 + 1
    ell = tb.BlockEll(
        bcols=torch.empty((Kb, maxblk), dtype=torch.int32, device="meta"),
        blocks=torch.empty((Kb, 1, maxblk, 1), dtype=torch.bfloat16,
                           device="meta"), nrows=Kb)
    V = torch.zeros((Kb, 8))
    assert "block slots" in tb.ell_kernel_unsupported(ell, V)
    flat = tb.FlatBsr(
        brows=torch.empty(Kb, dtype=torch.int32, device="meta"),
        bcols=torch.empty(Kb * maxblk, dtype=torch.int32, device="meta"),
        blocks=torch.empty((Kb, 1, maxblk), dtype=torch.bfloat16,
                           device="meta"),
        row_ptr=torch.empty(Kb + 1, dtype=torch.int32, device="meta"),
        nrows=Kb)
    assert "block slots" in tb.flat_kernel_unsupported(flat, V)
    small = dataclasses.replace(flat, bcols=flat.bcols[:Kb * 8],
                                blocks=flat.blocks[:, :, :8])
    assert "block slots" not in (tb.flat_kernel_unsupported(small, V) or "")
