"""Port parity: the ADMM SDP oracle (sig_sdp_mmw_torch.models.admm vs
sig_sdp_mmw_tpu.models.admm), float64 on the K=75 fixture.  X_final within
1e-7·max|X| of the JAX one after 30 and 100 iterations; the factor's Gram
``X_half X_halfᵀ`` within 1e-7 (eigh may flip a column's sign, so the
factor is compared through its Gram) where the rank cut falls in a gap of
X_final's spectrum; the kept rank min(K, (Z-1)·rank_radio) the same.  At
Z=8 the cut (rank 14) falls inside an eigenvalue of X_final that repeats 15
times, so which 14 directions either package keeps is arbitrary: there the
kept eigenvalues agree to 1e-7 and each kept column is an eigenvector of the
port's X_final.  Last, BinarySearchRelaxation + ADMMSDPSolver, rounding
on the JAX package's draws (``fold_in(PRNGKey(1234), n)``), probes the same
Z sequence to the same Z_fin, with remainder 0 and the verifier passing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.models import admm as ja
from sig_sdp_mmw_tpu.models import BinarySearchRelaxation as JBS
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.models import admm as ta
from sig_sdp_mmw_torch.models import base as tbase
from sig_sdp_mmw_torch.models import BinarySearchRelaxation, verify_assignment
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def states(mmw_small):
    js = j_state(mmw_small["S"], mmw_small["Q"], mmw_small["h_max"],
                 dtype=jnp.float64)
    return js, from_jax_arrays(jax_fields(js)), int(mmw_small["Z_fin"])


@pytest.mark.parametrize("nit,Z,rank_radio,cut_in_gap",
                         [(30, 6, 3, True), (100, 6, 3, True),
                          (100, 8, 2, False)])
def test_admm_solve_matches_jax(states, nit, Z, rank_radio, cut_in_gap):
    js, ts, _ = states
    rank_pad = 32
    Hj, Xj = ja.admm_sdp_solve(js, float(Z), nit=nit, rank_pad=rank_pad,
                               rank_radio=rank_radio)
    Ht, Xt = ta.admm_sdp_solve(ts, float(Z), nit=nit, rank_pad=rank_pad,
                               rank_radio=rank_radio)
    Hj, Xj, Ht, Xt = (np.asarray(Hj), np.asarray(Xj), Ht.numpy(),
                      Xt.numpy())
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-7 * np.abs(Xj).max())
    rank = ta.admm_rank(js.K, Z, rank_radio)
    w = np.sort(np.abs(np.linalg.eigvalsh(Xj)))[::-1]
    assert (w[rank - 1] - w[rank] > 1e-6) == cut_in_gap
    if cut_in_gap:
        np.testing.assert_allclose(Ht @ Ht.T, Hj @ Hj.T, rtol=0, atol=1e-7)
    else:
        lam_t = np.sum(Ht * Ht, axis=0)[:rank]
        lam_j = np.sum(Hj * Hj, axis=0)[:rank]
        np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-7)
        np.testing.assert_allclose(Xt @ Ht[:, :rank], Ht[:, :rank] * lam_t,
                                   rtol=0, atol=1e-7)
    assert rank == min(js.K, (Z - 1) * rank_radio)
    kept_j = np.flatnonzero(np.any(Hj != 0, axis=0))
    kept_t = np.flatnonzero(np.any(Ht != 0, axis=0))
    np.testing.assert_array_equal(kept_t, np.arange(rank))
    np.testing.assert_array_equal(kept_j, kept_t)
    assert np.all(Ht[js.K:] == 0.0)


def test_admm_search_matches_jax(states, monkeypatch):
    js, ts, _ = states
    jbs = JBS()
    jbs.feasibility_check_alg = ja.ADMMSDPSolver(nit=100)
    zj, Zj, remj = jbs.run(js)

    monkeypatch.setattr(tbase, "TorchDraws", lambda seed, device, stream: (
        JaxDraws(jax.random.fold_in(jax.random.PRNGKey(seed), stream))))
    bs = BinarySearchRelaxation()
    alg = ta.ADMMSDPSolver(nit=100)
    bs.feasibility_check_alg = alg
    zt, Zt, remt = bs.run(ts)

    probes_j = jbs.LOGGED_NP_DATA["bs_search_per_it"][:, 3:8]
    probes_t = bs.LOGGED_NP_DATA["bs_search_per_it"][:, 3:8]
    np.testing.assert_array_equal(probes_t, probes_j)   # lo, hi, mid, Z, rem
    assert (Zt, remt) == (Zj, remj) and remt == 0
    assert verify_assignment(ts, zt)[0]
    assert {"admm_problem_setup", "admm_solve"} <= set(alg.LOGGED_NP_DATA)
