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


def test_cpu_takes_the_plain_recurrence_and_counts_its_steps(operator):
    """A CPU tensor runs the plain version (counted as ``"plain"`` steps, no
    kernel launch); a device without a kernel raises."""
    A, V = operator
    At, Vt = torch.from_numpy(A), torch.from_numpy(V)
    n0 = te.lanczos_tridiag.launches
    s0 = dict(te.lanczos_tridiag.route_steps)
    got = te.lanczos_tridiag(lambda x: At @ x, Vt, 12)
    assert te.lanczos_tridiag.route_steps == {"kernel": s0["kernel"],
                                              "plain": s0["plain"] + 12}
    assert te.lanczos_tridiag.launches == n0
    want = te.lanczos_tridiag_reference(lambda x: At @ x, Vt, 12)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert te.lanczos_route(Vt.device) == "plain"
    with pytest.raises(ValueError, match="no kernel for device meta"):
        te.lanczos_tridiag(lambda x: x, torch.zeros((8, 2), device="meta"), 4)


def test_operator_forms_are_the_callable(operator):
    """LanczosOperator(f, s) and a SplitOperator compute, through the plain
    version, exactly what the callable they replace computes: s * f(V), and
    the split form's sum in its order (the products on V padded to nrows)."""
    A, V = operator
    At, Vt = torch.from_numpy(A), torch.from_numpy(V)
    kw = dict(small_method="taylor_ss", norm_bound=2.0)
    F1, s1 = te.lanczos_expm_multiply(
        te.LanczosOperator(lambda x: At @ x, 0.5), Vt, 14, **kw)
    F2, s2 = te.lanczos_expm_multiply(lambda x: 0.5 * (At @ x), Vt, 14, **kw)
    assert torch.equal(F1, F2) and torch.equal(s1, s2)
    rng = np.random.default_rng(1)
    d, h = (torch.from_numpy(rng.standard_normal(60)) for _ in range(2))
    Qm, Sm = (torch.from_numpy(rng.standard_normal((64, 64)) / 8)
              for _ in range(2))
    Qm = Qm + Qm.T
    op = te.SplitOperator(d=d, h=h, products=(lambda P: Qm @ P,
                                              lambda P: Sm @ P,
                                              lambda P: Sm.T @ P),
                          nrows=64, operand_dtype=torch.float64, scale=0.5)
    X = torch.from_numpy(rng.standard_normal((60, 5)))
    Xp = torch.cat([X, torch.zeros((4, 5), dtype=X.dtype)])
    want = (d[:, None] * X + (Qm @ Xp)[:60]
            + h[:, None] * (Sm @ Xp)[:60]
            + (Sm.T @ torch.cat([h[:, None] * X,
                                 torch.zeros((4, 5), dtype=X.dtype)]))[:60])
    assert torch.equal(op(X), 0.5 * want)
    assert torch.equal(te.LanczosOperator(op)(X), op(X))


def test_combine_reference_is_the_sum_over_the_basis():
    rng = np.random.default_rng(2)
    Q = torch.from_numpy(rng.standard_normal((6, 40, 3)))
    c = torch.from_numpy(rng.standard_normal((3, 6)))
    F = te.lanczos_combine(Q, c)
    assert F.shape == (40, 3)
    np.testing.assert_allclose(F.numpy(), np.einsum("ikd,di->kd", Q.numpy(),
                                                    c.numpy()), rtol=1e-12)
