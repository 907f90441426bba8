"""Port parity: the dense environment (sig_sdp_mmw_torch.env.{env,phy,mob}
vs sig_sdp_mmw_tpu.env) on the reference fixtures' geometry: channel
state to the fixture at rtol 2e-5 (Q exact) and to JAX, SINR and BLER
compared as tests/test_env.py compares them, mobility with shared redraws
(float64, 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.env import env as jenv
from sig_sdp_mmw_tpu.env import phy as jphy
from sig_sdp_mmw_torch.env import env as tenv
from sig_sdp_mmw_torch.env import phy as tphy
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def _params(fix):
    return (jenv.EnvParams(cell_size=int(fix["cell_size"]),
                           sta_density_per_1m2=float(fix["density"])),
            tenv.EnvParams(cell_size=int(fix["cell_size"]),
                           sta_density_per_1m2=float(fix["density"])))


def test_phy_loss_and_db_match_jax():
    dis = np.linspace(0.0, 500.0, 101)
    got = tphy.fre_dis_to_loss_db(4e9, torch.from_numpy(dis)).numpy()
    want = np.asarray(jphy.fre_dis_to_loss_db(4e9, jnp.asarray(dis)))
    np.testing.assert_allclose(got, want, rtol=1e-13)
    assert tphy.dec_to_db(123.4) == jphy.dec_to_db(123.4)


@pytest.mark.parametrize("fix_name", ["env_small", "env_mid"])
def test_rxpr_and_state_match_reference_and_jax(fix_name, request):
    fix = request.getfixturevalue(fix_name)
    jp, tp_ = _params(fix)
    sta, aps = fix["sta_locs"], fix["ap_locs"]
    np.testing.assert_allclose(tenv.ap_grid(tp_).numpy(), aps, rtol=1e-6)
    rxpr = tenv.rxpr_unthresholded(torch.from_numpy(sta),
                                   torch.from_numpy(aps), tp_)
    np.testing.assert_allclose(rxpr.numpy(), fix["rxpr_real"], rtol=2e-5)
    jr = jenv.rxpr_unthresholded(jnp.asarray(sta), jnp.asarray(aps), jp)
    np.testing.assert_allclose(rxpr.numpy(), np.asarray(jr), rtol=1e-12)
    thr = tenv.threshold_rxpr(rxpr, tp_)
    np.testing.assert_allclose(thr.numpy(), fix["rxpr_thr"], rtol=2e-5)
    S, Q, h, asso = tenv.state_arrays_from_rxpr(thr, tp_)
    np.testing.assert_allclose(S.numpy(), fix["S"], rtol=2e-5)
    np.testing.assert_array_equal(Q.numpy(), fix["Q"])
    np.testing.assert_allclose(h.numpy(), fix["h_max"], rtol=2e-5, atol=1e-7)
    jS, jQ, jh, jasso = jenv.state_arrays_from_rxpr(
        jenv.threshold_rxpr(jr, jp), jp)
    np.testing.assert_array_equal(asso.numpy(), np.asarray(jasso))
    np.testing.assert_array_equal(Q.numpy(), np.asarray(jQ))
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-12)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-12)


@pytest.mark.parametrize("fix_name", ["env_small", "env_mid"])
def test_evaluate_sinr_bler_match_reference_and_jax(fix_name, request):
    """Same-slot users of one AP have equal SINR in exact arithmetic, so
    the winner is rounding noise: compare sorted values, the count of 1e-3
    losers and at most 10% mismatched in place (tests/test_env.py)."""
    fix = request.getfixturevalue(fix_name)
    jp, tp_ = _params(fix)
    z = fix["z_test"]
    sinr = tenv.evaluate_sinr_from_rxpr(torch.from_numpy(fix["rxpr_real"]),
                                        torch.from_numpy(z), tp_).numpy()
    jsinr = np.asarray(jenv.evaluate_sinr_from_rxpr(
        jnp.asarray(fix["rxpr_real"]), jnp.asarray(z.astype(np.int32)), jp))
    for ref in (fix["sinr"], jsinr):
        np.testing.assert_allclose(np.sort(sinr), np.sort(ref), rtol=2e-5)
        assert np.sum(sinr == 1e-3) == np.sum(ref == 1e-3)
        assert (~np.isclose(sinr, ref, rtol=2e-5)).mean() <= 0.1
    bler = tenv.evaluate_bler_from_sinr(torch.from_numpy(sinr), tp_).numpy()
    np.testing.assert_allclose(np.sort(bler), np.sort(fix["bler"]), rtol=1e-4,
                               atol=1e-12)


def test_wireless_env_with_injected_geometry_matches_jax(env_mid):
    """WirelessEnv fed the fixture's users gives the JAX env's state (same
    geometry) and K; the same seed without injection gives other users
    with the same K."""
    je = jenv.WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=3,
                          pad_to=320)
    je.sta_locs = jnp.asarray(env_mid["sta_locs"])
    js = je.generate_S_Q_hmax()
    te = tenv.WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=3,
                          pad_to=320, device="cpu",
                          sta_locs=env_mid["sta_locs"])
    ts = te.generate_S_Q_hmax()
    assert (ts.K, ts.Kp) == (js.K, js.Kp) == (300, 320)
    assert ts.S.dtype == torch.float32 and ts.tensor_devices() == {"cpu"}
    np.testing.assert_allclose(ts.S.numpy(), np.asarray(js.S), rtol=1e-6)
    np.testing.assert_array_equal(ts.Q.numpy(), np.asarray(js.Q))
    np.testing.assert_allclose(ts.h_max.numpy(), np.asarray(js.h_max),
                               rtol=1e-6)
    assert ts.degree_bounds() == js.degree_bounds()
    z = env_mid["z_test"]
    np.testing.assert_allclose(np.sort(te.evaluate_bler(z, 8)),
                               np.sort(np.asarray(je.evaluate_bler(z, 8))),
                               rtol=1e-4, atol=1e-12)
    drawn = tenv.WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075,
                             seed=3, device="cpu")
    assert drawn.sta_locs.shape == (300, 2)
    assert not np.allclose(drawn.sta_locs.numpy(), env_mid["sta_locs"])


def test_mobility_substep_matches_jax():
    rng = np.random.default_rng(0)
    locs = rng.uniform(0.0, 100.0, (64, 2))
    locs[:8] = rng.uniform(99.9995, 100.0, (8, 2))     # these leave the grid
    dirs = rng.normal(size=(64, 2))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    key = jax.random.PRNGKey(5)
    jl, jd = jenv.mobility_substep(key, jnp.asarray(locs), jnp.asarray(dirs),
                                   1.0, 1000.0, 100.0)
    rnd = torch.from_numpy(np.array(jax.random.normal(key, dirs.shape)))
    tl, td = tenv.mobility_substep(rnd, torch.from_numpy(locs),
                                   torch.from_numpy(dirs), 1.0, 1000.0, 100.0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-12)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
    stayed = np.all(tl.numpy() == locs, axis=1)
    assert 0 < stayed.sum() < 64


def test_env_structure_mobility_and_packet_loss():
    e = tenv.WirelessEnv(cell_size=5, sta_density_per_1m2=0.0075, seed=0,
                         device="cpu")
    assert e.n_sta == 75 and e.n_ap == 25
    st = e.generate_state()
    K = st.K
    S, Q, h = st.S.numpy()[:K, :K], st.Q.numpy()[:K, :K], st.h_max.numpy()[:K]
    assert np.array_equal(Q, Q.T) and np.all(np.diag(Q) == 0)
    np.testing.assert_allclose(h, np.diag(S) / e.min_sinr - 1.0, rtol=1e-5)
    assert np.all(h > 0) and np.count_nonzero(S) / (K * K) < 0.5
    # all users in one slot: nearly every packet fails
    assert e.evaluate_bler(np.zeros(K, int), 1).mean() >= 0.99
    pckl = e.evaluate_pckl(np.zeros(K, int), 1)
    assert pckl.shape == (K,) and pckl.dtype == np.int32 and pckl.sum() > 60
    locs0 = e.sta_locs.numpy().copy()
    e.rand_user_mobility(mobility_in_meter_s=1.0, t_us=1e6,
                         resolution_us=1e5)
    moved = np.linalg.norm(e.sta_locs.numpy() - locs0, axis=1)
    assert np.median(moved) > 0.0 and np.max(moved) <= 1.0 + 1e-9
    assert np.all(e.sta_locs.numpy() >= 0.0)
    assert np.all(e.sta_locs.numpy() <= e.params.grid_edge)


def test_wireless_env_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.WirelessEnv(cell_size=5, sta_density_per_1m2=0.0075)
