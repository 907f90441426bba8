"""Port parity: native-scan rounding and the CSR verifier
(sig_sdp_mmw_torch.models.rounding_ell vs sig_sdp_mmw_tpu.models.rounding_ell).
With the same gX and the JAX draws handed to the port, the assignment and
the remainder must be identical."""

import jax
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
from sig_sdp_mmw_tpu.models import rounding_ell as jr
from sig_sdp_mmw_torch.core.ell import ell_from_scipy as t_ell
from sig_sdp_mmw_torch.models import rounding_ell as tr
from torch_jax_parity import JaxDraws
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def state():
    return generate_large_state_csr(10, 75e-4, seed=2)


@pytest.mark.parametrize("Z,nattempt", [(14, 3), (9, 2)],
                         ids=["feasible", "remainder_fill"])
def test_rounding_native_csr_matches_jax(state, Z, nattempt):
    S, Q, h = state
    K = S.shape[0]
    gX = np.random.default_rng(7).standard_normal((K + 4, 32))
    gX[K:] = 0.0
    key = jax.random.PRNGKey(5)
    zj, Zj, remj = jr.rounding_native_csr(Z, gX, S, Q, h, key,
                                          nattempt=nattempt)
    zt, Zt, remt = tr.rounding_native_csr(Z, torch.from_numpy(gX), S, Q, h,
                                          JaxDraws(key), nattempt=nattempt)
    assert (Zt, remt) == (Zj, remj)
    np.testing.assert_array_equal(zt, np.asarray(zj))
    if Z == 9:
        assert remt > 0          # the random-fill path ran
    assert zt.min() >= 0 and zt.max() < Z


def test_verify_assignment_csr_matches_jax(state):
    S, Q, h = state
    rng = np.random.default_rng(8)
    for Z in (6, 12, 30):
        z = rng.integers(0, Z, S.shape[0])
        assert (tr.verify_assignment_csr(S, Q, h, z)
                == jr.verify_assignment_csr(S, Q, h, z))


def test_default_z_pad_matches_jax(state):
    ej, et = j_ell(*state), t_ell(*state)
    for Z in (None, 3, 16, 17, 60, 130):
        assert tr.default_z_pad_ell(et, Z) == jr.default_z_pad_ell(ej, Z)
