"""Port parity: the ELL heuristics (sig_sdp_mmw_torch.models.heuristics_ell
vs sig_sdp_mmw_tpu.models.heuristics_ell) on the K=300 reference geometry
(tests/fixtures/env_mid.npz) in float64: the scores to 1e-12, and with the
JAX draws (JaxDraws of PRNGKey(777) and PRNGKey(4242)) the same (z_vec,
ZZ, rem) from MAX_GAIN_ELL, MAX_ASSO_ELL and MAX_RAND_ELL, at a fixed Z and
with the slot budget grown until everyone fits (not_Z_bound)."""

import jax
import numpy as np
import pytest
import scipy.sparse

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.models import heuristics_ell as jh
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.models import heuristics_ell as th
from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_ell
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def states(env_mid):
    S = scipy.sparse.csr_matrix(env_mid["S"])
    Q = scipy.sparse.csr_matrix(env_mid["Q"])
    ej = j_ell(S, Q, env_mid["h_max"], dtype=np.float64)
    return ej, tell.from_jax_arrays(jax_fields(ej))


def test_scores_match_jax(states):
    ej, et = states
    np.testing.assert_allclose(th.incoming_gain_scores(et).numpy(),
                               np.asarray(jh.incoming_gain_scores(ej)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(th.asso_degree_scores(et).numpy(),
                               np.asarray(jh.asso_degree_scores(ej)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("Z,not_Z_bound", [(14, False), (9, False),
                                           (0, True)],
                         ids=["Z14", "Z9", "not_Z_bound"])
@pytest.mark.parametrize("name", ["MAX_GAIN_ELL", "MAX_ASSO_ELL"])
def test_score_heuristics_match_jax(states, name, Z, not_Z_bound):
    """(z_vec, ZZ, rem) equal the JAX package's; rem == 0 exactly when the
    checker passes."""
    ej, et = states
    zj, ZZj, remj = getattr(jh, name).run(Z, ej, not_Z_bound=not_Z_bound)
    zt, ZZt, remt = getattr(th, name).run(
        Z, et, not_Z_bound=not_Z_bound,
        draws=JaxDraws(jax.random.PRNGKey(777)))
    assert (ZZt, remt) == (ZZj, remj)
    np.testing.assert_array_equal(zt, np.asarray(zj))
    assert verify_assignment_ell(et, zt)[0] == (remt == 0)
    if not_Z_bound:
        assert remt == 0


@pytest.mark.parametrize("Z", [30, 12])
def test_max_rand_matches_jax(states, Z):
    """(z_vec, Z, rem) equal the JAX package's.  The random order permutes
    all Kp users and the scan visits its first K, so a padded user drawn
    early leaves a valid one unvisited, counted in rem and given a random
    slot that may still fit: here rem > 0 with a feasible assignment, as
    in the JAX package."""
    ej, et = states
    zj, Zj, remj = jh.MAX_RAND_ELL.run(Z, ej)
    zt, Zt, remt = th.MAX_RAND_ELL.run(
        Z, et, draws=JaxDraws(jax.random.PRNGKey(4242)))
    assert (Zt, remt) == (Zj, remj)
    np.testing.assert_array_equal(zt, np.asarray(zj))
    assert remt > 0 and verify_assignment_ell(et, zt)[0]
