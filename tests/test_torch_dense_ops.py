"""Port parity: the dense path's small operators (sig_sdp_mmw_torch.ops.
{expm,rsvd} vs sig_sdp_mmw_tpu.ops) on shared inputs, float64 to 1e-8 of
the largest entry.  The rsvd's eigenvectors may flip sign between the two
libraries, so it is compared as U·diag(s)·Uᵀ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.ops.expm import taylor_expm_multiply as j_taylor
from sig_sdp_mmw_tpu.ops.rsvd import randomized_symmetric_lowrank as j_rsvd
from sig_sdp_mmw_tpu.ops.rsvd import rsvd_half_factor as j_half
from sig_sdp_mmw_torch.ops.expm import taylor_expm_multiply as t_taylor
from sig_sdp_mmw_torch.ops.rsvd import randomized_symmetric_lowrank as t_rsvd
from sig_sdp_mmw_torch.ops.rsvd import rsvd_half_factor as t_half
from torch_jax_parity import JaxDraws
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def _sym(n, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return scale * (a + a.T) / (2.0 * np.sqrt(n))


@pytest.mark.parametrize("steps", [1, 4])
def test_taylor_expm_multiply_matches_jax(steps):
    A = _sym(40, 0, 2.0)
    V = np.random.default_rng(1).normal(size=(40, 3))
    want = np.asarray(j_taylor(lambda X: jnp.asarray(A) @ X, jnp.asarray(V),
                               steps))
    At = torch.from_numpy(A)
    got = t_taylor(lambda X: At @ X, torch.from_numpy(V), steps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("rank", [4, 12])
def test_randomized_symmetric_lowrank_matches_jax(rank):
    """A rank-16 PSD matrix plus a little noise, the shape of an averaged
    primal; Ω shared (``JaxDraws.omega`` is the JAX key fold_in(key,
    nit+1))."""
    rng = np.random.default_rng(2)
    F = rng.normal(size=(80, 16))
    A = F @ F.T + 1e-3 * _sym(80, 3)
    key = jax.random.PRNGKey(7)
    draws = JaxDraws(key, nit=30)
    jkey = jax.random.fold_in(key, 31)
    Uj, sj = (np.asarray(x) for x in j_rsvd(jnp.asarray(A), rank, jkey))
    Ut, st = t_rsvd(torch.from_numpy(A), rank, draws)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-8 * sj.max())
    Mj = (Uj * sj) @ Uj.T
    Mt = (Ut.numpy() * st.numpy()) @ Ut.numpy().T
    np.testing.assert_allclose(Mt, Mj, rtol=0, atol=1e-8 * np.abs(Mj).max())
    Hj = np.asarray(j_half(jnp.asarray(A), rank, jkey))
    Ht = t_half(torch.from_numpy(A), rank, draws).numpy()
    np.testing.assert_allclose(Ht @ Ht.T, Hj @ Hj.T, rtol=0,
                               atol=1e-8 * np.abs(Hj @ Hj.T).max())
