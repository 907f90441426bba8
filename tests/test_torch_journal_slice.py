"""The journal comparison slice end to end on the CPU.

* ``sim_all_bler``'s per-instance body (``compare_at_z``: Rand, LRP,
  MAX_GAIN and MAX_ASSO, each rounded at the fixture's Z and put through
  BLER) on the K=75 reference geometry gives the JAX package's z_vec and
  remainder, exactly, and its per-user BLER, with the JAX package's draws on
  its schedule (``fold_in(PRNGKey(seed), n)`` per solver call, the rounding's
  ``fold_in(PRNGKey(1234), n)``, the heuristics' ``PRNGKey(777)``).  Where
  the JAX package's order is decided by the last bits of a sum, the test
  shares those bits as it shares the draws: MAX_GAIN's scores, and the row
  norms of Rand's unit-row factor (its users' order in the rounding), come
  from the JAX package.
* Each ported experiment runs with ``--smoke --device cpu`` and writes the
  same metric files, with the same row lengths, as the JAX script run with
  the same arguments (here the cheaper four; the other five are in
  test_torch_journal_experiments.py); ``pd_mmw_template`` returns the JAX
  script's methods.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.env import WirelessEnv as JEnv
from sig_sdp_mmw_tpu.models import (LRPSolver as JLRP, MAX_ASSO as JASSO,
                                    MAX_GAIN as JGAIN,
                                    RandSDPSolver as JRand)
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.env import WirelessEnv
from sig_sdp_mmw_torch.experiments.sim_all_bler import compare_at_z
from sig_sdp_mmw_torch.models import base, baselines, heuristics, lrp
from sig_sdp_mmw_torch.models import verify_assignment
from torch_jax_parity import JaxDraws, check_experiment_metrics, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def _jax_draws(seed, device, stream=0):
    key = jax.random.PRNGKey(seed)
    return JaxDraws(jax.random.fold_in(key, stream) if stream else key,
                    nattempt=10)


def _jax_norm(x, dim=None, keepdim=False):
    out = jnp.linalg.norm(jnp.asarray(x.numpy()), axis=dim, keepdims=keepdim)
    return torch.from_numpy(np.array(out))


def test_compare_at_z_matches_jax(env_small, monkeypatch):
    seed, Z = 1, int(env_small["Z_test"])
    je = JEnv(cell_size=5, sta_density_per_1m2=0.0075, seed=seed)
    je.sta_locs = jnp.asarray(env_small["sta_locs"])
    js = je.generate_S_Q_hmax()
    te = WirelessEnv(cell_size=5, sta_density_per_1m2=0.0075, seed=seed,
                     device="cpu", sta_locs=env_small["sta_locs"])
    ts = from_jax_arrays(jax_fields(js))

    # The JAX package's sim_all_bler body at Z.
    ref = {}
    rnd = JRand(seed=seed)
    _, gX = rnd.run_with_state(0, Z, js)
    z, _, rem = rnd.rounding(Z, gX, js)
    ref["rand"] = (z, rem)
    lp = JLRP(nit=100, seed=seed)
    _, P = lp.run_with_state(0, Z, js)
    z, _, rem = lp.rounding(Z, P, js)
    ref["ladmm"] = (z, rem)
    for name, cls in (("mgain", JGAIN), ("masso", JASSO)):
        z, _, rem = cls.run(Z, js)
        ref[name] = (z, rem)

    for mod in (base, baselines, lrp, heuristics):
        monkeypatch.setattr(mod, "TorchDraws", _jax_draws)
    scores = torch.from_numpy(np.array(JGAIN._scores(js)))
    monkeypatch.setattr(heuristics.MAX_GAIN, "_scores",
                        classmethod(lambda c, st: scores))
    monkeypatch.setattr(torch.linalg, "norm", _jax_norm)
    got = compare_at_z(te, ts, Z, seed)
    monkeypatch.undo()

    assert set(got) == set(ref) == {"rand", "ladmm", "mgain", "masso"}
    for name, (zj, remj) in ref.items():
        zt, remt, bler, secs = got[name]
        assert remt == remj, name
        np.testing.assert_array_equal(zt, zj, err_msg=name)
        np.testing.assert_allclose(bler, np.asarray(je.evaluate_bler(zj, Z)),
                                   rtol=0, atol=1e-9, err_msg=name)
        assert bler.shape == (75,) and secs >= 0.0
        if remt == 0:
            assert verify_assignment(ts, zt)[0], name


# Each script at a small cell (K=27) with its JAX test's arguments; the
# costlier ones are in test_torch_journal_experiments.py.
EXPERIMENTS = [("sim_graph_test", []), ("sim_all_bler", []),
               ("sim_mmw_oracle_z", ["--oracle_nit", "200"]),
               ("sim_online_iterations", [])]


@pytest.mark.parametrize("script,extra", EXPERIMENTS,
                         ids=[e[0] for e in EXPERIMENTS])
def test_experiment_writes_the_jax_metrics(script, extra, tmp_path):
    check_experiment_metrics(script, extra, tmp_path)


def test_pd_mmw_template_runs_every_method():
    """The port's rows name the JAX script's methods in its order
    (sig_sdp_mmw_tpu/experiments/pd_mmw_template.py:41-62); the JAX script
    itself is not run (about 20 s of compiles for a list of names)."""
    from sig_sdp_mmw_torch.experiments import pd_mmw_template as tpd

    tres = tpd.main(["--smoke", "--cells", "3", "--seed", "0", "--device",
                     "cpu"])
    assert [r[0] for r in tres] == ["mmw", "lrp", "admm", "mgain", "masso",
                                    "mrand"]
    for row in tres:
        name, Z, rem, mean, mx = row
        assert Z >= 2 and rem >= 0 and 0.0 <= mean <= mx <= 1.0, row
    assert tres[0][2] == 0                 # the MMW search ends feasible
