"""Port parity: the batched solves and probe searches
(sig_sdp_mmw_torch.parallel.batch vs sig_sdp_mmw_tpu.parallel.batch) on the
K=75 fixture (tests/fixtures/mmw_small.npz).

* solve_scenarios_batched, with the JAX draws, gives each instance the
  JAX package's solve (float64: |Δub| <= 1e-8, the Gram X_half X_halfᵀ to
  1e-6 of its max), is the per-instance mmw_solve with each instance's
  draws, and refuses a mesh;
* ParallelProbeSearch (dense, max_probes=12), with the JAX draws, returns
  the JAX package's Z, remainder and z_vec, and a verified feasible Z
  within 1 of the port's own binary search;
* ParallelProbeSearchEll on 16x16 float32 blocks, with the JAX draws,
  returns the JAX package's Z, feasible and verified, and in segments of 30
  iterations the same Z."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_sig_state
from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.parallel import ParallelProbeSearch as JPP
from sig_sdp_mmw_tpu.parallel import ParallelProbeSearchEll as JPPE
from sig_sdp_mmw_tpu.parallel import solve_scenarios_batched as j_batched
from sig_sdp_mmw_tpu.parallel import stack_states as j_stack
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.core.problem import (from_jax_arrays,
                                            state_from_arrays, state_to_scipy)
from sig_sdp_mmw_torch.models import MMW, BinarySearchRelaxation
from sig_sdp_mmw_torch.models.mmw import mmw_solve
from sig_sdp_mmw_torch.models.rounding import verify_assignment
from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_ell
from sig_sdp_mmw_torch.parallel import (ParallelProbeSearch,
                                        ParallelProbeSearchEll,
                                        solve_scenarios_batched, stack_states)
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

NIT = 40


@pytest.fixture(scope="module")
def states(mmw_small):
    """The fixture and a copy with 10% smaller budgets, float64, as JAX
    states and the port's copies of them."""
    js = [j_state(mmw_small["S"], mmw_small["Q"], f * mmw_small["h_max"],
                  dtype=jnp.float64) for f in (1.0, 0.9)]
    return js, [from_jax_arrays(jax_fields(s)) for s in js]


def _gram(X):
    X = np.asarray(X, np.float64)
    return X @ X.T


def test_batched_solve_is_per_instance_solve(states):
    """Two instances at per-instance Z: each output is the JAX package's
    batched solve, and mmw_solve's with the instance's own draws."""
    js, ts = states
    kw = dict(nit=10, eta=0.05, D_pad=32, rank_pad=32)
    key = jax.random.PRNGKey(3)
    oj = j_batched(j_stack(js), jnp.asarray([8.0, 9.0]), key=key, **kw)
    stacked = stack_states(ts)
    draws = JaxDraws(key, nit=kw["nit"])
    out = solve_scenarios_batched(stacked, [8.0, 9.0], draws=draws, **kw)
    assert out.X_half.shape == (2, ts[0].Kp, 32)
    assert out.X_half.dtype == torch.float64
    for b, (st, Z) in enumerate(zip(ts, (8.0, 9.0))):
        ub = float(oj.ub_final[b])
        assert abs(float(out.ub_final[b]) - ub) <= 1e-8
        want = _gram(oj.X_half[b])
        np.testing.assert_allclose(_gram(out.X_half[b]), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        one = mmw_solve(st, Z, draws=draws.scenario_solve(b, 2), **kw)
        torch.testing.assert_close(out.X_half[b], one.X_half, rtol=0,
                                   atol=0)
        assert float(out.ub_final[b]) == float(one.ub_final)
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        solve_scenarios_batched(stacked, 8.0, draws=draws, mesh=object(),
                                **kw)


def test_parallel_probe_search_dense(states):
    """With the JAX draws (``fold_in(PRNGKey(0), 1)``, the first call's
    key): the JAX Z, remainder and z_vec; rem 0, verified, and Z within 1
    of the port's binary search."""
    js, ts = states
    kw = dict(nit=NIT, eta=0.05, seed=0, max_probes=12)
    zj, Zj, remj = JPP(**kw).run(js[0])
    pp = ParallelProbeSearch(**kw)
    z, Z, rem = pp.run(ts[0], draws=JaxDraws(
        jax.random.fold_in(jax.random.PRNGKey(0), 1), nit=NIT))
    assert (Z, rem) == (int(Zj), int(remj))
    np.testing.assert_array_equal(np.asarray(z), np.asarray(zj))
    assert rem == 0 and verify_assignment(ts[0], z)[0]
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = MMW(nit=NIT, eta=0.05, seed=0)
    _, Z_bin, rem_bin = bs.run(ts[0])
    assert rem_bin == 0 and abs(Z - Z_bin) <= 1


@pytest.fixture(scope="module")
def jax_spec(mmw_small):
    """The JAX package's speculative search on 16x16 float32 blocks (its
    own test's configuration) and its ELL state."""
    ref = j_state(mmw_small["S"], mmw_small["Q"], mmw_small["h_max"],
                  dtype=jnp.float32)
    ell = ell_from_sig_state(ref)
    S, Q, _ = state_to_scipy(state_from_arrays(
        mmw_small["S"], mmw_small["Q"], mmw_small["h_max"]))
    pp = JPPE(nit=NIT, eta=0.05, seed=0, wave=4,
              use_bcsr=True).prepare(ell, S, Q, block=16)
    _, Z, rem = pp.run(ell)
    return ell, S, Q, int(Z), int(rem)


@pytest.mark.parametrize("wave_segment", [None, 30],
                         ids=["single_shot", "segments_of_30"])
def test_parallel_probe_search_ell_matches_jax(jax_spec, wave_segment):
    ell_j, S, Q, Z_jax, rem_jax = jax_spec
    et = tell.from_jax_arrays(jax_fields(ell_j))
    pp = ParallelProbeSearchEll(nit=NIT, eta=0.05, seed=0, wave=4,
                                use_bcsr=True, wave_segment=wave_segment
                                ).prepare(et, S, Q, block=16)
    z, Z, rem = pp.run(et, draws=JaxDraws(
        jax.random.fold_in(jax.random.PRNGKey(0), 1), nit=NIT))
    assert rem == rem_jax == 0
    assert Z == Z_jax
    ok, ni, na = verify_assignment_ell(et, z)
    assert ok, (ni, na)
    waves = pp.LOGGED_NP_DATA["pp_wave"]
    assert waves.shape[0] == int(pp.LOGGED_NP_DATA["pp_search"][0, -2])
