"""Port parity: the block pair and the block Grams
(sig_sdp_mmw_torch.ops.bcsr vs sig_sdp_mmw_tpu.ops.bcsr).

``bcsr_pair_from_state`` must give the JAX arrays bit for bit; the two
block Grams must agree with JAX to 1e-6 of the largest entry in float32 and
1e-12 in float64 (inputs drawn with numpy from a seed, on the fixtures'
interference graphs at 16x16 and 32x32 blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_tpu.ops import bcsr as jb
from sig_sdp_mmw_torch.core.ell import ell_from_scipy
from sig_sdp_mmw_torch.ops import bcsr as tb
from sig_sdp_mmw_torch.ops.ell import ell_spmm
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = ["env_small", "env_mid"]
BLOCKS = [16, 32]
_DT = {"f32": (np.float32, 1e-6), "f64": (np.float64, 1e-12)}


def _csr(fix):
    return (scipy.sparse.csr_matrix(fix["S"].astype(np.float64)),
            scipy.sparse.csr_matrix(fix["Q"].astype(np.float64)))


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("fix_name", FIXTURES)
def test_block_pair_matches_jax(fix_name, block, request):
    S, Q = _csr(request.getfixturevalue(fix_name))
    j_s, j_st = jb.bcsr_pair_from_state(S, Q, block=block)
    t_s, t_st = tb.bcsr_pair_from_state(S, Q, block=block, device="cpu")
    for t, j in ((t_s, j_s), (t_st, j_st)):
        assert t.nrows == j.nrows and t.nrows % block == 0
        np.testing.assert_array_equal(t.bcols.numpy(), np.asarray(j.bcols))
        np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))


@pytest.mark.parametrize("fix_name", FIXTURES)
def test_block_pair_feeds_the_block_ell_product(fix_name, request):
    """S tilde and its transpose through ``bcsr_spmm`` (the plain version on
    the CPU) give the ELL products of the same state, to the tolerance of
    tests/test_ell.py::test_bcsr_spmm_matches_ell."""
    fix = request.getfixturevalue(fix_name)
    S, Q = _csr(fix)
    s_b, st_b = tb.bcsr_pair_from_state(S, Q, block=16, device="cpu")
    ell = ell_from_scipy(S, Q, fix["h_max"])
    K, Kp = S.shape[0], ell.Kp
    V = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (Kp, 8)).astype(np.float32))
    Vp = torch.nn.functional.pad(V, (0, 0, 0, max(s_b.nrows - Kp, 0)))
    for mat, cols, vals in ((s_b, ell.s_cols, ell.s_vals),
                            (st_b, ell.st_cols, ell.st_vals)):
        got = tb.bcsr_spmm(mat, Vp)[:K]
        want = ell_spmm(cols.long(), vals, V)[:K]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _operands(fix, block, np_dtype):
    S, Q = _csr(fix)
    s_b, _ = tb.bcsr_pair_from_state(S, Q, block=block, device="cpu")
    rng = np.random.default_rng(block)
    Xb = rng.standard_normal((s_b.Kb, block, 6)).astype(np_dtype)
    acc = rng.standard_normal((s_b.Kb, s_b.bcols.shape[1], block, block)
                              ).astype(np_dtype)
    return s_b.bcols.numpy(), Xb, acc


@pytest.mark.parametrize("dt", sorted(_DT))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("fix_name", FIXTURES)
def test_block_gram_matches_jax(fix_name, block, dt, request):
    np_dtype, tol = _DT[dt]
    bcols, Xb, _ = _operands(request.getfixturevalue(fix_name), block,
                             np_dtype)
    want = jb.bcsr_block_gram(jnp.asarray(bcols), jnp.asarray(Xb))
    got = tb.bcsr_block_gram(torch.from_numpy(bcols).long(),
                             torch.from_numpy(Xb))
    assert got.shape == (bcols.shape[0], bcols.shape[1], block, block)
    _close(got, want, tol)


@pytest.mark.parametrize("dt", sorted(_DT))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("fix_name", FIXTURES)
def test_block_gram_accum_matches_jax(fix_name, block, dt, request):
    np_dtype, tol = _DT[dt]
    bcols, Xb, acc = _operands(request.getfixturevalue(fix_name), block,
                               np_dtype)
    want = jb.bcsr_block_gram_accum(jnp.asarray(bcols), jnp.asarray(Xb),
                                    jnp.asarray(acc), 0.37)
    t_acc = torch.from_numpy(acc.copy())
    got = tb.bcsr_block_gram_accum(torch.from_numpy(bcols).long(),
                                   torch.from_numpy(Xb), t_acc, 0.37)
    assert got is t_acc
    _close(got, want, tol)
