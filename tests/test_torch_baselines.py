"""Port parity: the Rand and Spectral relaxation baselines
(sig_sdp_mmw_torch.models.baselines vs sig_sdp_mmw_tpu.models.baselines),
float64 on the K=75 fixture.  Rand's factor equals the JAX one to 1e-12 on
the JAX draw of its call (``fold_in(PRNGKey(seed), n)``); Spectral's
subspace iteration from the JAX start block (``PRNGKey(seed)``) spans the
same subspace (projector ``Q Qᵀ``) with the same Ritz values to 1e-8
relative (QR may flip a column's sign, so factors are compared through
their projector); rounding the JAX factor in both packages gives the same
z_vec and remainder.

Both factors have unit rows, so every user ties in the rounding's user order
(decreasing row norm) and each package's norm, to its last bit, decides the
order.  The rounding parity test therefore scales row k by 1 + 1e-6·k: the
order is then fixed (by decreasing index) and each user's slot preferences,
which a positive row scale leaves as they are, come from the JAX factor."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.models import baselines as jb
import sig_sdp_mmw_tpu.models.rounding  # noqa: F401
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.models import baselines as tb
import sig_sdp_mmw_torch.models.rounding  # noqa: F401
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

jr = sys.modules["sig_sdp_mmw_tpu.models.rounding"]
tr = sys.modules["sig_sdp_mmw_torch.models.rounding"]


@pytest.fixture(scope="module")
def states(mmw_small):
    js = j_state(mmw_small["S"], mmw_small["Q"], mmw_small["h_max"],
                 dtype=jnp.float64)
    return js, from_jax_arrays(jax_fields(js)), int(mmw_small["Z_fin"])


@pytest.mark.parametrize("seed,ncall", [(0, 1), (3, 2)])
def test_rand_factor_matches_jax(states, seed, ncall):
    js, ts, Z = states
    alg = jb.RandSDPSolver(seed=seed)
    for _ in range(ncall):
        _, gj = alg.run_with_state(0, Z, js)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), ncall)
    gt = tb.rand_factor(ts, Z, 2, JaxDraws(key))
    assert gt.shape == (js.Kp, 2 * Z)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-12)
    norms = np.linalg.norm(gt.numpy(), axis=1)
    np.testing.assert_allclose(norms[: js.K], 1.0, atol=1e-12)
    assert np.all(norms[js.K:] == 0.0)


def test_rand_solver_streams_differ(states):
    _, ts, Z = states
    alg = tb.RandSDPSolver(seed=0)
    _, g1 = alg.run_with_state(0, Z, ts)
    _, g2 = alg.run_with_state(1, Z, ts)
    assert g1.shape == g2.shape and not torch.equal(g1, g2)


@pytest.mark.parametrize("k", [8, 12])
def test_subspace_topk_matches_jax(states, k):
    js, ts, _ = states
    key = jax.random.PRNGKey(0)
    eye = jnp.eye(js.Kp, dtype=bool)
    Ssym = jnp.where(eye, 0.0, js.S + js.S.T)
    Lap_j = jnp.diag(jnp.sum(Ssym, axis=1)) - Ssym
    Lap_t = tb.laplacian(ts)
    np.testing.assert_allclose(Lap_t.numpy(), np.asarray(Lap_j), rtol=0,
                               atol=1e-12)
    vj, wj = jb._subspace_topk(Lap_j, key, k=k)
    vt, wt = tb._subspace_topk(Lap_t, JaxDraws(key), k=k)
    vj, vt = np.asarray(vj), vt.numpy()
    scale = np.abs(np.asarray(wj)).max()
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(vt @ vt.T, vj @ vj.T, rtol=0, atol=1e-8)


def test_spectral_solver_matches_jax_projector(states, monkeypatch):
    js, ts, Z = states
    _, gj = jb.SpectralSDPSolver(seed=0).run_with_state(0, Z, js)
    monkeypatch.setattr(tb, "TorchDraws", lambda seed, device: JaxDraws(
        jax.random.PRNGKey(seed)))
    alg = tb.SpectralSDPSolver(seed=0)
    _, gt = alg.run_with_state(0, Z, ts)
    gj, gt = np.asarray(gj), gt.numpy()
    # Row-normalized top-Z vectors: the rows' Gram is sign-free.
    np.testing.assert_allclose(gt @ gt.T, gj @ gj.T, rtol=0, atol=1e-8)
    assert {"spectral_problem_setup", "spectral_solve"} <= set(
        alg.LOGGED_NP_DATA)


@pytest.mark.parametrize("kind", ["rand", "spectral"])
def test_rounding_the_jax_factor_matches(states, kind):
    js, ts, Z = states
    cls = jb.RandSDPSolver if kind == "rand" else jb.SpectralSDPSolver
    _, gX = cls(seed=1).run_with_state(0, Z, js)
    gX = np.asarray(gX) * (1.0 + 1e-6 * np.arange(js.Kp))[:, None]
    key = jax.random.PRNGKey(5)
    zj, _, remj = jr.rounding(Z, gX, js, key, nattempt=10)
    zt, _, remt = tr.rounding(Z, torch.from_numpy(np.array(gX)), ts,
                              JaxDraws(key, nattempt=10), nattempt=10)
    assert remt == remj
    np.testing.assert_array_equal(zt, zj)
