"""Port parity: the dense MMW solver (sig_sdp_mmw_torch.models.mmw vs
sig_sdp_mmw_tpu.models.mmw) on the K=75 reference fixture, the state
carried across with ``from_jax_arrays`` and the JAX package's draws handed
to the port by ``JaxDraws``.

Tolerances: float64, |Δub| <= 1e-8, the Gram X_half X_halfᵀ (signs of
eigenvectors may differ) to 1e-6 of its max, the gap log and X_avgd to
1e-8 of their max; float32, ub and the Gram to 2e-3 of their max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.preprocess import build_mmw_operands as j_ops
from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.models import mmw as jm
from sig_sdp_mmw_torch.core.preprocess import build_mmw_operands as t_ops
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.models import mmw as tm
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

NIT, Z = 30, 8.0
KW = dict(nit=NIT, eta=0.05, D_pad=32, rank_pad=32)
PROFILED_KEYS = {"mmw_state_process", "mmw_dual", "mmw_loss", "mmw_expm",
                 "mmw_per_it", "mmw_xavg", "mmw_all_it"}


def _states(fix, dt):
    js = j_state(fix["S"], fix["Q"], fix["h_max"], dtype=getattr(jnp, dt))
    return js, from_jax_arrays(jax_fields(js))


def _gram(X):
    X = np.asarray(X, np.float64)
    return X @ X.T


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _solve_both(fix, dt, **kw):
    js, ts = _states(fix, dt)
    key = jax.random.PRNGKey(0)
    oj = jax.jit(lambda st: jm.mmw_solve(st, Z, key=key, **KW, **kw))(js)
    ot = tm.mmw_solve(ts, Z, draws=JaxDraws(key, NIT), **KW, **kw)
    return oj, ot


def test_mmw_solve_float64_matches_jax(mmw_small):
    oj, ot = _solve_both(mmw_small, "float64", log_gap=True)
    assert ot.X_half.dtype == torch.float64 and ot.X_half.shape == (80, 32)
    assert abs(float(ot.ub_final) - float(oj.ub_final)) <= 1e-8
    _close(_gram(ot.X_half), _gram(oj.X_half), 1e-6)
    _close(ot.X_avgd, oj.X_avgd, 1e-8)
    assert ot.gap_log.shape == (NIT, 2)
    _close(ot.gap_log, oj.gap_log, 1e-8)


def test_mmw_solve_float32_matches_jax(mmw_small):
    oj, ot = _solve_both(mmw_small, "float32")
    assert ot.X_half.dtype == torch.float32 and ot.gap_log.shape == (0, 2)
    ub = float(oj.ub_final)
    assert abs(float(ot.ub_final) - ub) <= 2e-3 * abs(ub)
    _close(_gram(ot.X_half), _gram(oj.X_half), 2e-3)


def test_solver_pieces_match_jax(env_mid):
    """_masked_softmax_3, _violations and _loss_matrix on the K=300 state
    with random iterates."""
    js = j_state(env_mid["S"], env_mid["Q"], env_mid["h_max"], pad_to=320,
                 dtype=jnp.float64)
    opj = j_ops(js, 11.0)
    opt = t_ops(from_jax_arrays(jax_fields(js)), 11.0)
    rng = np.random.default_rng(0)
    Xd, Xo = rng.uniform(0.5, 1.5, 320), 0.2 * _sym(320, rng)
    Y = (rng.uniform(size=320), rng.uniform(size=(320, 320)),
         rng.uniform(size=320))
    t = torch.from_numpy
    Zt = torch.tensor(11.0, dtype=torch.float64)
    for got, want in zip(
            tm._violations(t(Xd), t(Xo), opt, Zt, 300),
            jm._violations(Xd, Xo, opj, 11.0, 300)):
        _close(got, want, 1e-12)
    masks_j = (opj.mask, opj.asso_ut, opj.mask)
    masks_t = (opt.mask, opt.asso_ut, opt.mask)
    for got, want in zip(tm._masked_softmax_3(*map(t, Y), *masks_t),
                         jm._masked_softmax_3(*Y, *masks_j)):
        _close(got, want, 1e-12)
    _close(tm._loss_matrix(*map(t, Y), opt, Zt, 300, 320),
           jm._loss_matrix(*Y, opj, 11.0, 300, 320), 1e-12)


def _sym(n, rng):
    a = rng.normal(size=(n, n))
    return (a + a.T) / 2.0


def test_profiled_solve_equals_fused_and_logs_reference_keys(mmw_small):
    _, ts = _states(mmw_small, "float64")
    a = tm.MMW(nit=10, eta=0.05, seed=3)
    _, Xp = a.run_with_state_profiled(0, 8, ts)
    b = tm.MMW(nit=10, eta=0.05, seed=3, log_gap=True)
    _, Xf = b.run_with_state(0, 8, ts)
    _close(_gram(Xp), _gram(Xf), 1e-10)
    tab = a.LOGGED_NP_DATA
    assert set(tab) == PROFILED_KEYS
    for k in ("mmw_dual", "mmw_loss", "mmw_expm", "mmw_per_it"):
        assert tab[k].shape == (10, 6) and np.all(tab[k][:, 5] > 0)
    assert b.LOGGED_NP_DATA["gap"].shape == (10, 6)
    assert b.LOGGED_NP_DATA["mmw_all_it"].shape == (1, 6)


@pytest.mark.parametrize("name,pad", [("mmw_small", None), ("env_mid", 320)])
def test_d_pad_matches_jax(name, pad, request):
    fix = request.getfixturevalue(name)
    js = j_state(fix["S"], fix["Q"], fix["h_max"], pad_to=pad)
    ts = from_jax_arrays(jax_fields(js))
    for rank_radio in (2, 3):
        ja = jm.MMW(rank_radio=rank_radio)
        ta = tm.MMW(rank_radio=rank_radio)
        for Zp in (2, 8, 47, 200):
            assert ta._d_pad_for(ts, Zp) == ja._d_pad_for(js, Zp)
