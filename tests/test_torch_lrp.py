"""Port parity: the LP relaxation baseline (sig_sdp_mmw_torch.models.lrp vs
sig_sdp_mmw_tpu.models.lrp), float64.  ``lrp_solve`` after 50 projection
rounds within 1e-8·max|P| of the JAX P (K=75 and K=300); ``lrp_residuals``
equal on the same P; the LP rounding of the JAX P, with the JAX fill draw
(``fold_in(PRNGKey(seed), n)``), gives the same z_vec and remainder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.models import lrp as jl
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.models import lrp as tl
from sig_sdp_mmw_torch.models.rounding import verify_assignment
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def solved(request):
    """Per (fixture, Z): the JAX state, the port's copy and the JAX P."""
    out = {}

    def get(name, pad, Z, Z_pad):
        if (name, Z) not in out:
            fix = request.getfixturevalue(name)
            js = j_state(fix["S"], fix["Q"], fix["h_max"], pad_to=pad,
                         dtype=jnp.float64)
            P = np.asarray(jl.lrp_solve(js, float(Z), nit=50, Z_pad=Z_pad))
            out[(name, Z)] = (js, from_jax_arrays(jax_fields(js)), P)
        return out[(name, Z)]
    return get


CASES = [("mmw_small", None, 8, 48), ("mmw_small", None, 10, 48),
         ("env_mid", 320, 8, 48)]
IDS = ["K75-Z8", "K75-Z10", "K300-Z8"]


@pytest.mark.parametrize("name,pad,Z,Z_pad", CASES, ids=IDS)
def test_lrp_solve_matches_jax(name, pad, Z, Z_pad, solved):
    js, ts, Pj = solved(name, pad, Z, Z_pad)
    Pt = tl.lrp_solve(ts, float(Z), nit=50, Z_pad=Z_pad).numpy()
    assert Pt.shape == (Z_pad, js.Kp)
    np.testing.assert_allclose(Pt, Pj, rtol=0, atol=1e-8 * np.abs(Pj).max())
    assert np.all(Pt[Z:] == 0.0) and np.all(Pt[:, js.K:] == 0.0)


@pytest.mark.parametrize("name,pad,Z,Z_pad", CASES, ids=IDS)
def test_lrp_residuals_match_jax(name, pad, Z, Z_pad, solved):
    js, ts, Pj = solved(name, pad, Z, Z_pad)
    assert tl.lrp_residuals(ts, torch.from_numpy(Pj.copy()), Z) == \
        jl.lrp_residuals(js, Pj, Z)


@pytest.mark.parametrize("seed,ncall", [(0, 1), (2, 3)])
@pytest.mark.parametrize("name,pad,Z,Z_pad", CASES, ids=IDS)
def test_lrp_round_matches_jax(name, pad, Z, Z_pad, seed, ncall, solved):
    js, ts, Pj = solved(name, pad, Z, Z_pad)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), ncall)
    zj, remj = jl._lrp_round(js, jnp.asarray(Pj), jnp.int32(Z), key,
                             Z_pad=Z_pad)
    zt, remt = tl._lrp_round(ts, torch.from_numpy(Pj.copy()), Z,
                             JaxDraws(key), Z_pad=Z_pad)
    assert remt == int(remj)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    if remt == 0:
        assert verify_assignment(ts, zt.numpy()[: js.K])[0]


def test_lrp_solver_matches_jax_solver(solved, monkeypatch):
    """The solver objects end to end: Z_pad from the degree bound, the
    metric keys, and call n's fill from stream n (JAX: fold_in(key, n))."""
    js, ts, _ = solved("mmw_small", None, 10, 48)
    jalg, talg = jl.LRPSolver(nit=50, seed=4), tl.LRPSolver(nit=50, seed=4)
    _, Pj = jalg.run_with_state(0, 10, js)
    _, Pt = talg.run_with_state(0, 10, ts)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=0,
                               atol=1e-8)
    assert {"lrp_problem_setup", "lrp_solve"} <= set(talg.LOGGED_NP_DATA)
    monkeypatch.setattr(tl, "TorchDraws", lambda seed, device, stream: (
        JaxDraws(jax.random.fold_in(jax.random.PRNGKey(seed), stream))))
    for _ in range(2):
        zj, Zj, remj = jalg.rounding(10, Pj, js)
        zt, Zt, remt = talg.rounding(10, torch.from_numpy(np.array(Pj)), ts)
        assert (Zt, remt) == (Zj, remj)
        np.testing.assert_array_equal(zt, zj)
