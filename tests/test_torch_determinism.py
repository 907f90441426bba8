"""Why the port's sums repeat bit for bit on the card.

A sum taken with ``index_add_`` into repeated indices adds with atomics on
CUDA, in an order that changes from run to run.  The port avoids that
where it matters:

* MAX_GAIN_ELL's rank (``models/heuristics_ell.py::incoming_gain_scores``)
  sums the association gains into shared in-neighbours with
  ``utils.tensors.index_sum_in_order``, one add per element and step: the
  tests hold it to the sequential scatter-add bit for bit and to the JAX
  package's scores to 1e-12 in float64;
* the edge Gram (``ops/bcsr.py::bcsr_edge_gram_accum``) adds each slot's
  entries with ``index_add_`` along ``g_dst[s]``, which is order-free only
  because no row of ``g_dst`` names a real target twice and only padding
  goes to the sink: the tests hold both packers' maps to that, at the
  million-link path's 128x128 blocks and the mid-K path's 32x32.
"""

import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.models import heuristics_ell as jh
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.models import heuristics_ell as th
from sig_sdp_mmw_torch.ops import bcsr as tb
from sig_sdp_mmw_torch.utils.tensors import index_sum_in_order
from torch_jax_parity import jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def state():
    return generate_large_state_csr(20, 75e-4, seed=2)   # K = 1,200


@pytest.mark.parametrize("shape", [(), (3,)], ids=["vector", "rows"])
@pytest.mark.parametrize("seed", [0, 1])
def test_index_sum_in_order_is_the_sequential_scatter(seed, shape):
    """Sources of random magnitude into heavily repeated targets (and some
    targets none reach): bitwise the CPU's sequential ``index_add_``, which
    adds them in index order."""
    rng = np.random.default_rng(seed)
    n, m = 50, 2000
    index = torch.from_numpy(rng.integers(0, n - 5, m))
    src = torch.from_numpy((rng.standard_normal((m, *shape))
                            * 10 ** rng.uniform(-4, 4, (m, *shape))
                            ).astype(np.float32))
    want = torch.zeros((n, *shape)).index_add_(0, index, src)
    got = index_sum_in_order(n, index.to(torch.int32), src)
    assert got.dtype == src.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert not got[n - 5:].any()
    assert torch.equal(index_sum_in_order(n, index[:0], src[:0]),
                       torch.zeros((n, *shape)))


def test_incoming_gain_scores_match_jax_in_float64(state):
    """MAX_GAIN_ELL's rank on a K=1,200 state, where many users share an
    association in-neighbour: the fixed-order sum within 1e-12 of the JAX
    package's scatter-add."""
    S, Q, h = state
    ej = j_ell(S, Q, h, dtype=np.float64)
    et = tell.from_jax_arrays(jax_fields(ej))
    shared = np.bincount(et.q_cols[et.q_mask].numpy().ravel())
    assert shared.max() > 1   # targets that take several adds
    np.testing.assert_allclose(th.incoming_gain_scores(et).numpy(),
                               np.asarray(jh.incoming_gain_scores(ej)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("block", [128, 32], ids=["1M-128x128",
                                                  "midK-32x32"])
@pytest.mark.parametrize("packer", ["numpy", "native"])
def test_edge_gram_maps_name_each_target_once(state, monkeypatch, packer,
                                              block):
    """Each row of ``g_dst`` names every real target (an edge index below
    nnz) at most once, every edge appears in exactly one row, and only the
    padding positions go to the sink (nnz); a padding position's source is
    entry 0 of the slot's block Gram.  So ``bcsr_edge_gram_accum``'s
    ``index_add_`` along a row adds at most once into each real element,
    in any order."""
    if packer == "native":
        monkeypatch.setattr(tb, "_NATIVE_PACK_MIN_NNZ", 0)
    S, Q, _ = state
    ops = tb.bcsr_operands_from_state(S, Q, block=block,
                                      dtype=torch.bfloat16)
    nnz = ops.nnz
    g_src, g_dst = ops.g_src.numpy(), ops.g_dst.numpy()
    assert g_dst.shape == g_src.shape
    assert g_dst.shape[0] == ops.s_blocks.bcols.shape[1]
    seen = np.zeros(nnz, np.int64)
    for src, dst in zip(g_src, g_dst):
        real = dst != nnz
        assert np.all((dst >= 0) & (dst <= nnz))
        assert np.unique(dst[real]).size == int(real.sum())
        # Real entries lead the row; the rest is padding into the sink.
        k = int(real.sum())
        assert real[:k].all() and not real[k:].any()
        assert not src[k:].any()
        seen += np.bincount(dst[real], minlength=nnz)
    assert np.all(seen == 1)
    assert (g_dst == nnz).any()   # there is padding to send to the sink
