"""Port parity: batched Lanczos, the Krylov exponential action and the
Lanczos extreme eigenvalues (sig_sdp_mmw_torch.ops vs sig_sdp_mmw_tpu.ops),
in float64 on a seeded symmetric operator, to 1e-9 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.models.mmw import mmw_default_lanczos_m as j_default_m
from sig_sdp_mmw_tpu.ops import expm as je
from sig_sdp_mmw_tpu.ops.lanczos import lanczos_extreme_eigs as j_eigs
from sig_sdp_mmw_torch.models.mmw import mmw_default_lanczos_m as t_default_m
from sig_sdp_mmw_torch.ops import expm as te
from sig_sdp_mmw_torch.ops.lanczos import lanczos_extreme_eigs as t_eigs
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-9


@pytest.fixture(scope="module")
def operator():
    rng = np.random.default_rng(0)
    B = rng.standard_normal((60, 60))
    A = (B + B.T) / np.sqrt(60.0)          # spectrum in about [-3, 3]
    V = rng.standard_normal((60, 5))
    V[:, 3] = 0.0                          # a zero column: the safe-divide path
    return A, V


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("reorth", [True, False])
def test_lanczos_tridiag_matches_jax(operator, reorth):
    A, V = operator
    At = torch.from_numpy(A)
    got = te.lanczos_tridiag(lambda x: At @ x, torch.from_numpy(V), 12,
                             reorth=reorth)
    Aj = jnp.asarray(A)
    want = je.lanczos_tridiag(lambda x: Aj @ x, jnp.asarray(V), 12,
                              reorth=reorth)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("small_method", ["taylor_ss", "eigh"])
def test_lanczos_expm_multiply_matches_jax(operator, small_method):
    A, V = operator
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    F, sigma = te.lanczos_expm_multiply(lambda x: 0.5 * (At @ x),
                                        torch.from_numpy(V), 14,
                                        small_method=small_method,
                                        norm_bound=2.0)
    Fj, sj = je.lanczos_expm_multiply(lambda x: 0.5 * (Aj @ x),
                                      jnp.asarray(V), 14,
                                      small_method=small_method,
                                      norm_bound=2.0)
    _close(F, Fj)
    _close(sigma, sj)
    # and it is the exponential action: exp(sigma) * F = expm(A/2) @ V
    w, U = np.linalg.eigh(0.5 * A)
    np.testing.assert_allclose(np.exp(float(sigma)) * F.numpy(),
                               (U * np.exp(w)) @ U.T @ V, rtol=1e-6,
                               atol=1e-8)


def test_lanczos_extreme_eigs_matches_jax(operator):
    A, _ = operator
    key = jax.random.PRNGKey(3)
    v = jax.random.normal(key, (60, 1), jnp.float64)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    lo, hi = t_eigs(lambda x: At @ x, torch.from_numpy(np.array(v)), m=24)
    lo_j, hi_j = j_eigs(lambda x: Aj @ x, key, 60, m=24, dtype=jnp.float64)
    _close(lo, lo_j)
    _close(hi, hi_j)


def test_krylov_defaults_match_jax():
    for nb in (0.0, 0.5, 7.5, 30.0, 200.0):
        assert te.default_lanczos_iters(nb) == je.default_lanczos_iters(nb)
    for eta, nit in ((0.05, 150), (0.05, 20), (0.1, 100), (0.02, 2500)):
        assert t_default_m(eta, nit) == j_default_m(eta, nit)
    assert t_default_m(0.05, 150) == 10
