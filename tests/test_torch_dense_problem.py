"""Port parity: the dense problem state and the MMW operands
(sig_sdp_mmw_torch.core.{problem,preprocess} vs sig_sdp_mmw_tpu.core) on the
K=75 and K=300 reference fixtures.  Tolerance: float64, |Δ| <= 1e-8; masks,
patterns and bounds exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.preprocess import build_mmw_operands as j_ops
from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_torch.core import problem as tp
from sig_sdp_mmw_torch.core.preprocess import build_mmw_operands as t_ops
from torch_jax_parity import jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

CASES = [("mmw_small", None), ("env_mid", 320)]


def _arrays(fix):
    return fix["S"], fix["Q"], fix["h_max"]


@pytest.mark.parametrize("name,pad", CASES)
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_state_and_bounds_match_jax(name, pad, dt, request):
    fix = request.getfixturevalue(name)
    js = j_state(*_arrays(fix), pad_to=pad, dtype=getattr(jnp, dt))
    ts = tp.state_from_arrays(*_arrays(fix), pad_to=pad,
                              dtype=getattr(torch, dt))
    for k, v in jax_fields(js).items():
        got = getattr(ts, k)
        if k == "K":
            assert got == v
        else:
            assert got.dtype == {"float32": torch.float32,
                                 "float64": torch.float64}.get(
                str(v.dtype), torch.bool)
            np.testing.assert_array_equal(got.numpy(), v)
    assert ts.degree_bounds() == js.degree_bounds()
    assert ts.asso_lower_bound() == js.asso_lower_bound()
    if name == "mmw_small":
        assert ts.degree_bounds() == (int(fix["lb"]), int(fix["ub"])) == (6, 46)
    # The bounds read from the tensors (no host cache) are the same.
    import dataclasses

    bare = dataclasses.replace(ts, lb_cache=-1, ub_cache=-1)
    assert bare.degree_bounds() == ts.degree_bounds()


@pytest.mark.parametrize("name,pad", CASES)
@pytest.mark.parametrize("Z", [2.0, 8.0, 13.0])
def test_mmw_operands_match_jax(name, pad, Z, request):
    fix = request.getfixturevalue(name)
    js = j_state(*_arrays(fix), pad_to=pad, dtype=jnp.float64)
    want = jax_fields(j_ops(js, Z))
    got = t_ops(tp.from_jax_arrays(jax_fields(js)), Z)
    assert got.K == want["K"]
    for k in ("asso_ut", "xpat", "mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k])
    for k in ("St", "S_sum", "norm_H", "h_max"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k],
                                   rtol=0, atol=1e-8)
    assert np.all(got.norm_H.numpy()[fix["S"].shape[0]:] == 1.0)


def test_from_jax_arrays_and_scipy_round_trip(env_mid):
    js = j_state(*_arrays(env_mid), pad_to=320, dtype=jnp.float64)
    ts = tp.from_jax_arrays(jax_fields(js))
    for k, v in jax_fields(js).items():
        if k != "K":
            np.testing.assert_array_equal(getattr(ts, k).numpy(), v)
    assert ts.K == 300 and ts.Kp == 320
    assert ts.degree_bounds() == js.degree_bounds()
    S, Q, h = tp.state_to_scipy(ts)
    np.testing.assert_array_equal(S.toarray(), env_mid["S"])
    np.testing.assert_array_equal(Q.toarray(), env_mid["Q"])
    back = tp.state_from_scipy((S, Q, h), pad_to=320, dtype=torch.float64)
    for k in ("S", "Q", "h_max", "mask"):
        assert torch.equal(getattr(back, k), getattr(ts, k))
    with pytest.raises(ValueError, match="pad_to"):
        tp.state_from_arrays(*_arrays(env_mid), pad_to=200)
