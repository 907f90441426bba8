"""Port parity: the device rounding of the sparse state
(sig_sdp_mmw_torch.models.rounding_ell vs sig_sdp_mmw_tpu.models.
rounding_ell) on the K=300 reference geometry (tests/fixtures/env_mid.npz)
in float64.  Given the same order and preferences, the sequential scan and
the wavefront return the JAX package's slots exactly; given the JAX draws
(JaxDraws), each route of rounding_ell returns its z_vec and remainder
exactly; the ELL checker agrees with JAX's and with the CSR checker; the
speculative search's one scan over a wave equals each attempt alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.models import rounding_ell as jr
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.models import rounding_ell as tr
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

Z_PAD = 16


@pytest.fixture(scope="module")
def states(env_mid):
    S = scipy.sparse.csr_matrix(env_mid["S"])
    Q = scipy.sparse.csr_matrix(env_mid["Q"])
    h = env_mid["h_max"]
    ej = j_ell(S, Q, h, dtype=np.float64)
    return ej, tell.from_jax_arrays(jax_fields(ej)), (S, Q, h)


def _order_pref(Kp, K, Z, seed):
    """A random user order (padded users last) and slot preference ranks
    (slots >= Z last), as numpy arrays."""
    rng = np.random.default_rng(seed)
    order = np.argsort(-np.where(np.arange(Kp) < K, rng.random(Kp), -np.inf),
                       kind="stable")
    scores = np.where(np.arange(Z_PAD)[:, None] < Z,
                      rng.random((Z_PAD, Kp)), -np.inf)
    pref = np.argsort(np.argsort(-scores, axis=0, kind="stable"), axis=0,
                      kind="stable")
    return order, pref


def _rollbacks(et, order, pref, Z):
    """Users the wavefront's repair pass returned to undecided: ready at the
    start of a round and undecided after it."""
    wf, prefT, state = tr._wavefront_setup(et, tr._rank_of(order), pref, Z,
                                           Z_PAD)
    n = 0
    while not bool(torch.all(state[2])):
        d = state[2]
        ready = ~d & ~(
            torch.any(wf["earlier_s"] & ~d[wf["scols"]], dim=1)
            | torch.any(wf["earlier_c"] & ~d[wf["ccols"]], dim=1)
            | torch.any(wf["earlier_q"] & ~d[wf["qcols"]], dim=1))
        state = tr._wavefront_round(et, wf, prefT, state)
        n += int(torch.sum(ready & ~state[2]))
    return n


@pytest.mark.parametrize("Z,seed,rollback", [(8, 4, True), (12, 3, False)],
                         ids=["repair", "feasible"])
def test_scan_and_wavefront_match_jax(states, Z, seed, rollback):
    """The same order and preferences: slot_of, remainder and assigned of
    both assignments equal the JAX package's.  At Z=8 the wavefront's
    repair pass rolls a user back; at Z=12 every user fits."""
    ej, et, _ = states
    order, pref = _order_pref(et.Kp, et.K, Z, seed)
    to, tp = torch.from_numpy(order), torch.from_numpy(pref)
    assert (_rollbacks(et, to, tp, Z) > 0) == rollback
    for jfn, tfn in ((jr._greedy_assign_ell, tr._greedy_assign_ell),
                     (jr._greedy_assign_ell_wavefront,
                      tr._greedy_assign_ell_wavefront)):
        sj, rj, aj = jfn(ej, jnp.asarray(order), jnp.asarray(pref),
                         jnp.int32(Z), Z_PAD)
        st, rt, at = tfn(et, to, tp, Z, Z_PAD)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        assert int(rt) == int(rj)
    if not rollback:
        assert int(rt) == 0


@pytest.mark.parametrize("Z", [12, 7], ids=["feasible", "no_attempt_fits"])
@pytest.mark.parametrize("route", ["batch", "sequential", "wavefront"])
def test_rounding_ell_routes_match_jax(states, monkeypatch, route, Z):
    """rounding_ell on each route, the route reached through both packages'
    module thresholds (the batched route is the default at Kp=304): z_vec
    and remainder equal the JAX package's with the JAX draws, including a Z
    at which no attempt assigns every user (the fallback fill runs)."""
    ej, et, _ = states
    if route == "wavefront":
        for mod in (jr, tr):
            monkeypatch.setattr(mod, "_WAVEFRONT_MIN_KP", 0)
    kw = {} if route == "batch" else {"batch_attempts": False}
    gX = np.random.default_rng(3).standard_normal((et.Kp, 24))
    gX[et.K:] = 0.0
    key = jax.random.PRNGKey(11)
    zj, _, remj = jr.rounding_ell(Z, jnp.asarray(gX), ej, key, nattempt=3,
                                  **kw)
    info = {}
    zt, Zt, remt = tr.rounding_ell(Z, torch.from_numpy(gX), et,
                                   JaxDraws(key, nattempt=3), nattempt=3,
                                   info=info, **kw)
    assert info["route"] == route and Zt == Z
    assert remt == remj
    np.testing.assert_array_equal(zt, np.asarray(zj))
    assert (remt == 0) == (Z == 12)
    assert zt.min() >= 0 and zt.max() < Z
    if route == "wavefront":
        # One entry per attempt run (the first with remainder 0 ends it).
        assert len(info["rounds"]) == 3 if remt else 1 <= len(info["rounds"])
        assert all(r > 0 for r in info["rounds"])


def test_verify_assignment_ell_matches_jax_and_csr(states):
    """The ELL checker's verdict and violation counts equal the JAX
    package's and the CSR checker's, on feasible and infeasible
    assignments."""
    ej, et, (S, Q, h) = states
    rng = np.random.default_rng(4)
    for Z in (3, 9, 40, 120):
        z = rng.integers(0, Z, et.K)
        want = jr.verify_assignment_ell(ej, z)
        assert tr.verify_assignment_ell(et, z) == want
        assert tr.verify_assignment_csr(S, Q, h, z) == want


def test_wave_scan_is_each_candidate_alone(states):
    """The speculative search's one scan over every candidate and attempt
    (a user order per row, a slot count per row) returns, for each
    (candidate, attempt), exactly that attempt rounded on its own; one Z
    of the three fits no attempt."""
    _, et, _ = states
    rng = np.random.default_rng(5)
    Xs = [torch.from_numpy(rng.standard_normal((et.Kp, 24))) for _ in range(3)]
    for X in Xs:
        X[et.K:] = 0.0
    Zs = np.array([7, 10, 14])
    draws = TorchDraws(2)
    ds = [[draws.candidate_round(a, i, 3) for a in range(2)]
          for i in range(3)]
    z, rem = tr._rounding_wave_ell(et, Xs, Zs, ds, Z_PAD)
    assert z.shape == (3, 2, et.Kp) and rem.shape == (3, 2)
    for i in range(3):
        for a in range(2):
            zi, ri = tr._rounding_single_ell(et, Xs[i], int(Zs[i]), ds[i][a],
                                             Z_PAD)
            torch.testing.assert_close(z[i, a], zi, rtol=0, atol=0)
            assert int(rem[i, a]) == int(ri)
    assert bool(torch.all(rem[0] > 0)) and int(rem[2].min()) == 0
