"""Port parity: the sparse MMW solve (sig_sdp_mmw_torch.models.mmw_ell vs
sig_sdp_mmw_tpu.models.mmw_ell) on the same K=300 state and operands,
carried across with ``from_jax_arrays``, and the same random draws (the
JAX package's, handed to the port by ``JaxDraws``).

Tolerances: float64, |Δub| < 1e-8 and the Gram X_half X_halfᵀ to 1e-6 of
its max (the averaged-Gram accumulator is float32 in both); float32,
|Δub| < 1e-4 (the tests/test_ell.py:124 standard) and the Gram to 2e-3 of
its max (the tests/test_ell.py:178 standard).  The float64 block-operand
runs use ``gram_mode="edge"``: the JAX block accumulator is float32-typed
and its loop refuses a float64 carry."""

import jax
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell as j_solve
from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state as j_ops
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.models.mmw_ell import MMWEll
from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell as t_solve
from sig_sdp_mmw_torch.ops import bcsr as tb
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

NIT = 15
KW = dict(eta=0.05, D_pad=32, rank_pad=32, lanczos_m=8)


@pytest.fixture(scope="module")
def state():
    S, Q, h = generate_large_state_csr(10, 75e-4, seed=2)
    lb = int(np.diff(Q.indptr).max()) + 1
    return S, Q, h, float(lb + 3)


def _gram(X):
    X = np.asarray(X, np.float64)
    return X @ X.T


def _run_both(state, dtype, gram_mode="auto", backend="flat", nit=NIT,
              **kw):
    S, Q, h, Z = state
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    ej = j_ell(S, Q, h, dtype=np_dt)
    opj = None
    if backend == "flat":
        opj = j_ops(S, Q, block=128, dtype=np_dt, store_transpose=True,
                    flat_group=4)
    key = jax.random.PRNGKey(0)
    oj = j_solve(ej, Z, nit=nit, key=key, bcsr=opj, gram_mode=gram_mode,
                 **KW, **kw)
    et = tell.from_jax_arrays(jax_fields(ej))
    opt = None if opj is None else tb.from_jax_arrays(jax_fields(opj))
    ot = t_solve(et, Z, nit=nit, draws=JaxDraws(key, nit), bcsr=opt,
                 gram_mode=gram_mode, **KW, **kw)
    assert ot.X_half.dtype == dtype
    return oj, ot


@pytest.mark.parametrize("backend,gram_mode", [("flat", "edge"),
                                               ("ell", "auto")])
def test_mmw_solve_ell_float64_matches_jax(state, backend, gram_mode):
    oj, ot = _run_both(state, torch.float64, gram_mode, backend)
    assert abs(float(ot.ub_final) - float(oj.ub_final)) < 1e-8
    Gj = _gram(oj.X_half)
    assert np.abs(_gram(ot.X_half) - Gj).max() <= 1e-6 * np.abs(Gj).max()


@pytest.mark.parametrize("gram_mode", ["auto", "edge"])
def test_mmw_solve_ell_float32_matches_jax(state, gram_mode):
    oj, ot = _run_both(state, torch.float32, gram_mode)
    assert abs(float(ot.ub_final) - float(oj.ub_final)) < 1e-4
    Gj = _gram(oj.X_half)
    assert np.abs(_gram(ot.X_half) - Gj).max() <= 2e-3 * np.abs(Gj).max()


def test_mmw_solve_ell_gap_log_matches_jax(state):
    """log_gap: the (UB, LB) trajectory, LB from the gap Lanczos on the
    averaged loss, in float64; factorize=False skips the epilogue."""
    oj, ot = _run_both(state, torch.float64, "edge", nit=4, log_gap=True,
                       gap_lanczos_m=16, factorize=False)
    want = np.asarray(oj.gap_log)
    assert want.shape == (4, 2)
    np.testing.assert_allclose(ot.gap_log.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    assert float(torch.abs(ot.X_half).max()) == 0.0


def test_slim_state_matches_jax_and_full_state(state):
    """EllSlim arrays equal the JAX slim build, and a slim-state solve
    equals the full-state one."""
    from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr as j_slim

    S, Q, h, Z = state
    sj = jax_fields(j_slim(S, Q, h, dtype=np.float64))
    st = tell.ell_slim_from_csr(S, Q, h, dtype=np.float64)
    for k, v in sj.items():
        if k == "K":
            assert st.K == v
        else:
            np.testing.assert_array_equal(getattr(st, k).numpy(), v)
    ops = tb.bcsr_operands_from_state(S, Q, block=128, dtype=torch.float64,
                                      flat_group=4)
    full = tell.ell_from_scipy(S, Q, h, dtype=np.float64)
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    a = t_solve(full, Z, nit=5, draws=TorchDraws(1), bcsr=ops, **KW)
    b = t_solve(st, Z, nit=5, draws=TorchDraws(1), bcsr=ops, **KW)
    assert abs(float(a.ub_final) - float(b.ub_final)) < 1e-12
    np.testing.assert_allclose(b.X_half.numpy(), a.X_half.numpy(),
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="EllSlim"):
        t_solve(st, Z, nit=1, draws=TorchDraws(1), **KW)


def test_ell_state_matches_jax(state):
    S, Q, h, _ = state
    ej = jax_fields(j_ell(S, Q, h))
    et = tell.ell_from_scipy(S, Q, h)
    for k, v in ej.items():
        if isinstance(v, int):
            assert getattr(et, k) == v, k
        else:
            np.testing.assert_array_equal(getattr(et, k).numpy(), v)
    assert et.degree_bounds() == j_ell(S, Q, h).degree_bounds()
    # the array fallback (no host caches) gives the same bounds
    import dataclasses

    bare = dataclasses.replace(et, lb_cache=-1, ub_cache=-1)
    assert bare.degree_bounds() == et.degree_bounds()


def test_mmwell_pins_sketch_width_and_needs_prepare(state):
    """The first probe pins (D_pad, rank_pad); a smaller later Z reuses it;
    a solve, or a native rounding, without prepare() is refused.  The
    device rounding (the default) needs no host state and pins its Z_pad
    the same way."""
    S, Q, h, _ = state
    ell = tell.ell_from_scipy(S, Q, h)
    alg = MMWEll(nit=2, eta=0.05, use_bcsr=True, lanczos_m=8)
    with pytest.raises(RuntimeError, match="prepare"):
        alg.run_with_state(0, 40, ell)
    alg.prepare(ell, S, Q, h_max=h, block=128, flat_group=4)
    _, X = alg.run_with_state(0, 40, ell)
    assert X.shape == (ell.Kp, 128)
    _, X = alg.run_with_state(1, 12, ell)
    assert X.shape == (ell.Kp, 128) and alg._pinned[1:] == (128, 128)
    other = tell.ell_from_scipy(S, Q, h)
    with pytest.raises(RuntimeError, match="prepare"):
        MMWEll(nit=2, eta=0.05, rounding="native").rounding(12, X, other)
    alg.rounding(40, X, ell, nattempt=1)
    alg.rounding(12, X, ell, nattempt=1)
    assert alg._pinned_zpad[1] == 64 and alg.rounding_info[-1]["route"] == "batch"
    with pytest.raises(ValueError, match="rounding must be"):
        MMWEll(rounding="host")
