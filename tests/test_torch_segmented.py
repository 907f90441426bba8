"""Segmented execution of the sparse MMW solve (sig_sdp_mmw_torch.models.
mmw_ell: carry_in / it_start / num_steps / return_carry) and
mmw_ell_ub_from_carry, on the K=300 state of the port's other solver tests
with block-ELL operands (128x128 blocks, stored transpose).

* 7 + 7 + 7 iterations plus the finish equal one 21-iteration run bit for
  bit (float64, CPU): the draws, the Gram gate and the gap log take the
  absolute index;
* the JAX segmented run (the tests/test_ell.py:291-323 schedule) and the
  port's, with the JAX draws injected: ub to 1e-4 (float32, the
  tests/test_ell.py:124 standard);
* mmw_ell_ub_from_carry of the port vs the JAX one on the same carry (the
  JAX carry after 14 iterations, carried across): to 1e-6.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_ell_ub_from_carry as j_ub
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell as j_solve
from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state as j_ops
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.models.mmw_ell import mmw_ell_ub_from_carry as t_ub
from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell as t_solve
from sig_sdp_mmw_torch.ops import bcsr as tb
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from torch_jax_parity import JaxDraws, jax_fields, to_torch
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

NIT = 21
KW = dict(nit=NIT, eta=0.05, D_pad=32, rank_pad=32, lanczos_m=8)


@pytest.fixture(scope="module")
def state():
    S, Q, h = generate_large_state_csr(10, 75e-4, seed=2)
    lb = int(np.diff(Q.indptr).max()) + 1
    return S, Q, h, float(lb + 3)


def _segments(solve, ell, Z, bounds, **kw):
    """Run ``solve`` segment by segment over [i0, i1) bounds, then finish."""
    c = None
    for i0, i1 in bounds:
        c = solve(ell, Z, carry_in=c, it_start=i0, num_steps=i1 - i0,
                  return_carry=True, **kw)
    return c, solve(ell, Z, carry_in=c, it_start=NIT, num_steps=0, **kw)


@pytest.mark.parametrize("gram_mode", ["edge", "block"])
def test_segmented_equals_single_run(state, gram_mode):
    S, Q, h, Z = state
    ell = tell.ell_from_scipy(S, Q, h, dtype=np.float64)
    ops = tb.bcsr_operands_from_state(S, Q, block=128, dtype=torch.float64,
                                      store_transpose=True)
    kw = dict(KW, bcsr=ops, gram_mode=gram_mode, log_gap=True,
              gap_lanczos_m=8, spmm_row_chunk=2)
    ref = t_solve(ell, Z, draws=TorchDraws(3), **kw)
    c, out = _segments(t_solve, ell, Z, [(0, 7), (7, 14), (14, 21)],
                       draws=TorchDraws(3), **kw)
    assert torch.equal(out.X_half, ref.X_half)
    assert torch.equal(out.ub_final, ref.ub_final)
    assert torch.equal(out.gap_log, ref.gap_log)
    assert torch.equal(t_ub(ell, Z, c, NIT), ref.ub_final)
    # The carry holds the accumulator the epilogue reads.
    assert ("avg_edge" if gram_mode == "edge" else "avg_blocks") in c


def test_segmented_matches_jax_segmented(state):
    S, Q, h, Z = state
    ej = j_ell(S, Q, h, dtype=np.float32)
    opj = j_ops(S, Q, block=128, dtype=np.float32, store_transpose=True)
    key = jax.random.PRNGKey(0)
    seg7 = jax.jit(functools.partial(
        lambda e, k, b, c, i0, **kk: j_solve(
            e, Z, key=k, bcsr=b, carry_in=c, it_start=i0, num_steps=7,
            return_carry=True, **kk), **KW))
    fin = jax.jit(lambda e, k, b, c: j_solve(
        e, Z, key=k, bcsr=b, carry_in=c, it_start=NIT, num_steps=0, **KW))
    c = seg7(ej, key, opj, None, 0)
    c = seg7(ej, key, opj, c, 7)
    c14 = {k: np.asarray(v) for k, v in c.items()}
    c = seg7(ej, key, opj, c, 14)
    oj = fin(ej, key, opj, c)

    et = tell.from_jax_arrays(jax_fields(ej))
    opt = tb.from_jax_arrays(jax_fields(opj))
    _, ot = _segments(t_solve, et, Z, [(0, 7), (7, 14), (14, 21)],
                      draws=JaxDraws(key, NIT), bcsr=opt, **KW)
    assert abs(float(ot.ub_final) - float(oj.ub_final)) < 1e-4

    # The UB read from one carry, by both packages.
    want = float(j_ub(ej, Z, {k: jax.numpy.asarray(v)
                              for k, v in c14.items()}, 14))
    got = float(t_ub(et, Z, {k: to_torch(v) for k, v in c14.items()}, 14))
    assert abs(got - want) < 1e-6
