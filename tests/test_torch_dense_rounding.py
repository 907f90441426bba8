"""Port parity: the dense rounding (sig_sdp_mmw_torch.models.rounding vs
sig_sdp_mmw_tpu.models.rounding).  With the JAX package's draws on the
dense schedule (attempt a from ``split(key, nattempt)[a]``, the one
fallback from ``fold_in(key, 99)``) and gX from a JAX solve, the port
returns the same z_vec and remainder, exactly, in float64.  One case has
a Z where no attempt succeeds, which pins "the last attempt" and the
single fallback draw."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.models import mmw as jm
import sig_sdp_mmw_tpu.models.rounding  # noqa: F401
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
import sig_sdp_mmw_torch.models.rounding  # noqa: F401
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

# The packages' ``models.rounding`` attribute is the function (re-exported
# by ``models/__init__``); the modules are read from sys.modules.
jr = sys.modules["sig_sdp_mmw_tpu.models.rounding"]
tr = sys.modules["sig_sdp_mmw_torch.models.rounding"]


@pytest.fixture(scope="module")
def solved(request):
    """Per fixture: the JAX state, the port's copy and gX of a JAX solve."""
    out = {}

    def get(name, fix, pad, Z):
        if name not in out:
            js = j_state(fix["S"], fix["Q"], fix["h_max"], pad_to=pad,
                         dtype=jnp.float64)
            o = jax.jit(lambda st: jm.mmw_solve(
                st, float(Z), nit=20, eta=0.05, D_pad=32, rank_pad=32,
                key=jax.random.PRNGKey(1)))(js)
            out[name] = (js, from_jax_arrays(jax_fields(js)),
                         np.array(o.X_half))
        return out[name]
    return get


# (fixture, pad, Z of the solve, Z of the rounding, nattempt)
CASES = [("mmw_small", None, 8, 8, 10), ("mmw_small", None, 8, 8, 1),
         ("mmw_small", None, 8, 6, 3), ("env_mid", 320, 11, 11, 10)]


@pytest.mark.parametrize("name,pad,Zs,Zr,nattempt", CASES,
                         ids=["K75", "K75-one", "K75-none-ok", "K300"])
def test_rounding_matches_jax_exactly(name, pad, Zs, Zr, nattempt, solved,
                                      request):
    js, ts, gX = solved(name, request.getfixturevalue(name), pad, Zs)
    key = jax.random.PRNGKey(11)
    zj, Zj, remj = jr.rounding(Zr, gX, js, key, nattempt=nattempt)
    draws = JaxDraws(key, nattempt=nattempt)
    if nattempt == 1:
        zt, Zt, remt = tr.rounding_one_attempt(Zr, torch.from_numpy(gX), ts,
                                               draws)
    else:
        zt, Zt, remt = tr.rounding(Zr, torch.from_numpy(gX), ts, draws,
                                   nattempt=nattempt)
    assert (Zt, remt) == (Zj, remj)
    assert zt.shape == (js.K,)
    np.testing.assert_array_equal(zt, zj)
    if Zr == 6:
        assert remj > 0                   # no attempt succeeded
    if remj:
        # the unassigned users hold the single fallback draw
        fill = draws.dense_fill(js.Kp, Zr).numpy()[: js.K]
        assert np.mean(zt == fill) > 0
    else:
        assert tr.verify_assignment(ts, zt)[0]


def test_verify_assignment_matches_jax(env_mid):
    js = j_state(env_mid["S"], env_mid["Q"], env_mid["h_max"], pad_to=320)
    ts = from_jax_arrays(jax_fields(js))
    rng = np.random.default_rng(0)
    cases = [np.zeros(300, int), env_mid["z_test"]]
    cases += [rng.integers(0, Z, 300) for Z in (4, 11, 40, 300)]
    for z in cases:
        assert tr.verify_assignment(ts, z) == jr.verify_assignment(js, z)
    assert not tr.verify_assignment(ts, cases[0])[0]
    assert tr._default_z_pad(ts) == jr._default_z_pad(js) == 64
