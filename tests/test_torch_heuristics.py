"""Port parity: the dense greedy heuristics (sig_sdp_mmw_torch.models.
heuristics vs sig_sdp_mmw_tpu.models.heuristics).  MAX_GAIN and MAX_ASSO
(the JAX package's slot-major packing; the port's user-major scan) give the
same z_vec, ZZ and remainder at Z = lb, at the fixture's Z_fin, with
``not_Z_bound=True`` and with ``nattempt=2``, on the JAX package's fill
draw (``PRNGKey(777)``); MAX_RAND gives the same with the JAX package's
``PRNGKey(4242)`` draws.  Float64, K=75 and K=300.

MAX_GAIN's scores are sums of gains, and users of one AP have the same
gains in other places: their scores agree to the last few bits, and each
package's summation order decides their rank (on the K=75 fixture, 72 of
the 75 users share their score with another user to 1e-12).  So MAX_GAIN
runs on the JAX package's scores, and its own scores are held to them to
1e-12; MAX_ASSO's integer scores tie exactly, and it runs on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.models import heuristics as jh
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.models import heuristics as th
from sig_sdp_mmw_torch.models.rounding import verify_assignment
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def states(request):
    out = {}

    def get(name, pad):
        if name not in out:
            fix = request.getfixturevalue(name)
            js = j_state(fix["S"], fix["Q"], fix["h_max"], pad_to=pad,
                         dtype=jnp.float64)
            out[name] = (js, from_jax_arrays(jax_fields(js)), fix)
        return out[name]
    return get


# (fixture, pad, Z: "lb" | "fin" | an int, not_Z_bound, nattempt)
CASES = [("mmw_small", None, "lb", False, 1),
         ("mmw_small", None, "fin", False, 1),
         ("mmw_small", None, "fin", True, 1),
         ("mmw_small", None, "fin", False, 2),
         ("env_mid", 320, "fin", False, 1),
         ("env_mid", 320, "fin", True, 1)]
IDS = ["K75-lb", "K75-Zfin", "K75-unbounded", "K75-nattempt2", "K300-Zfin",
       "K300-unbounded"]


def _z(spec, js, fix):
    if spec == "lb":
        return js.degree_bounds()[0]
    return int(fix["Z_fin"] if "Z_fin" in fix else fix["Z_test"])


@pytest.mark.parametrize("cls", ["MAX_GAIN", "MAX_ASSO"])
@pytest.mark.parametrize("name,pad,zspec,unbounded,nattempt", CASES, ids=IDS)
def test_slot_major_matches_jax(cls, name, pad, zspec, unbounded, nattempt,
                                states, monkeypatch):
    js, ts, fix = states(name, pad)
    Z = _z(zspec, js, fix)
    if cls == "MAX_GAIN":
        scores = torch.from_numpy(np.array(jh.MAX_GAIN._scores(js)))
        monkeypatch.setattr(th.MAX_GAIN, "_scores",
                            classmethod(lambda c, st: scores))
    zj, ZZj, remj = getattr(jh, cls).run(Z, js, nattempt=nattempt,
                                         not_Z_bound=unbounded)
    zt, ZZt, remt = getattr(th, cls).run(
        Z, ts, nattempt=nattempt, not_Z_bound=unbounded,
        draws=JaxDraws(jax.random.PRNGKey(777)))
    assert (ZZt, remt) == (ZZj, remj)
    np.testing.assert_array_equal(zt, zj)
    if unbounded:
        assert remt == 0 and ZZt <= js.K
    if remt == 0:
        assert verify_assignment(ts, zt)[0]
    if zspec == "lb":
        assert remj > 0            # lb is too few slots: the fill is drawn


@pytest.mark.parametrize("name,pad,zspec", [("mmw_small", None, "lb"),
                                            ("mmw_small", None, "fin"),
                                            ("env_mid", 320, "fin")],
                         ids=["K75-lb", "K75-Zfin", "K300-Zfin"])
def test_max_rand_matches_jax(name, pad, zspec, states):
    js, ts, fix = states(name, pad)
    Z = _z(zspec, js, fix)
    zj, Zj, remj = jh.MAX_RAND.run(Z, js)
    zt, Zt, remt = th.MAX_RAND.run(Z, ts,
                                   draws=JaxDraws(jax.random.PRNGKey(4242)))
    assert (Zt, remt) == (Zj, remj)
    np.testing.assert_array_equal(zt, zj)


@pytest.mark.parametrize("name,pad", [("mmw_small", None), ("env_mid", 320)])
@pytest.mark.parametrize("cls", ["MAX_GAIN", "MAX_ASSO"])
def test_scores_match_jax(cls, name, pad, states):
    js, ts, _ = states(name, pad)
    sj = np.asarray(getattr(jh, cls)._scores(js))
    np.testing.assert_allclose(getattr(th, cls)._scores(ts).numpy(), sj,
                               rtol=1e-12, atol=0)


def test_heuristics_default_draws_on_cpu(states):
    """Without injected draws the port draws from its own generators: the
    packing (no fill when everyone fits) is still the JAX package's."""
    js, ts, fix = states("mmw_small", None)
    zj, ZZj, remj = jh.MAX_ASSO.run(int(fix["Z_fin"]), js)
    zt, ZZt, remt = th.MAX_ASSO.run(int(fix["Z_fin"]), ts)
    assert remj == remt == 0 and ZZt == ZZj
    np.testing.assert_array_equal(zt, zj)
    z, Z, rem = th.MAX_RAND.run(int(fix["Z_fin"]), ts)
    assert z.shape == (js.K,) and Z == int(fix["Z_fin"]) and rem >= 0
    assert np.all((z >= 0) & (z < Z))
