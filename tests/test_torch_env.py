"""Port parity: scenario generation, PHY and sparse BLER evaluation
(sig_sdp_mmw_torch.env vs sig_sdp_mmw_tpu.env) on the same seeds."""

import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.env import phy as jphy
from sig_sdp_mmw_tpu.env.large import LargeEnv as JLargeEnv
from sig_sdp_mmw_tpu.env.large import generate_large_state_csr as jgenerate
from sig_sdp_mmw_torch.env import phy as tphy
from sig_sdp_mmw_torch.env.env import EnvParams
from sig_sdp_mmw_torch.env.large import LargeEnv as TLargeEnv
from sig_sdp_mmw_torch.env.large import generate_large_state_csr as tgenerate
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_generate_state_matches_jax_exactly(backend):
    Sj, Qj, hj = jgenerate(10, 75e-4, seed=2, backend=backend)
    St, Qt, ht = tgenerate(10, 75e-4, seed=2, backend=backend)
    for a, b in ((Sj, St), (Qj, Qt)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(hj, ht)


def test_phy_matches_jax():
    p = EnvParams()
    args = (p.packet_bit, p.bandwidth, p.slot_time, p.max_err)
    assert tphy.bisection_min_sinr_db(*args) == jphy.bisection_min_sinr_db(*args)
    assert tphy.min_sinr_dec(*args) == jphy.min_sinr_dec(*args)
    snr = np.logspace(-3, 3, 200)
    got = tphy.polyanskiy_model(torch.from_numpy(snr), *args[:3]).numpy()
    want = np.asarray(jphy.polyanskiy_model(snr, *args[:3]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("kw", [{}, dict(eval_min_ratio=0.1,
                                         tail_correction=False)],
                         ids=["full_channel", "in_graph_channel"])
def test_evaluate_bler_matches_jax(kw):
    je, te = JLargeEnv(10, seed=2), TLargeEnv(10, seed=2)
    K = te.K
    Z = 12
    z = np.random.default_rng(0).integers(0, Z, K)
    want = np.asarray(je.evaluate_bler(z, Z, **kw), np.float64)
    got = te.evaluate_bler(z, Z, **kw)
    assert got.shape == (K,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-300)


def test_evaluate_bler_reuses_geometry_exactly():
    """One environment evaluated several times (full and in-graph channel,
    other z and Z) keeps its z-independent parts and gives the same bits as
    a fresh environment, and JAX's values; a geometry of other users is
    refused."""
    from sig_sdp_mmw_torch.env.large import (ap_grid, evaluate_sinr_sparse,
                                             sparse_eval_geometry)

    je, te = JLargeEnv(10, seed=2), TLargeEnv(10, seed=2)
    rng = np.random.default_rng(1)
    calls = [(12, {}), (12, dict(eval_min_ratio=0.1, tail_correction=False)),
             (9, {}), (12, {})]
    for Z, kw in calls:
        z = rng.integers(0, Z, te.K)
        got = te.evaluate_bler(z, Z, **kw)
        np.testing.assert_array_equal(
            got, TLargeEnv(10, seed=2).evaluate_bler(z, Z, **kw))
        np.testing.assert_allclose(
            got, np.asarray(je.evaluate_bler(z, Z, **kw), np.float64),
            rtol=1e-6, atol=1e-300)
    p, aps = te.params, ap_grid(te.params)
    other = te.sta_locs.copy()
    with pytest.raises(ValueError, match="other users"):
        evaluate_sinr_sparse(other, aps, p, z, 12,
                             geometry=sparse_eval_geometry(te.sta_locs, aps,
                                                           p))
