"""The native block-ELL packers of the port (sig_sdp_mmw_torch.native.
builder: sig_bcsr_pack, sig_bcsr_gram_maps, sig_bcsr_sym_weights of the
shared csrc/sig_native.cpp) against the numpy path, bit for bit, with the
routing threshold lowered so a small state takes the native route; and the
guards the port adds around them (the caller's CSR is never sorted in
place, the weights refuse unsorted indices, maxblk is the packer's own)."""

import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.native import builder
from sig_sdp_mmw_torch.ops import bcsr as tb
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

_FIELDS = ("g_src", "g_dst", "w_edge", "s_pos", "q_bcols", "q_pos", "q_eidx")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


@pytest.fixture(scope="module")
def state():
    return generate_large_state_csr(40, 75e-4, seed=2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(8, 128), (128, 128)])
def test_native_operands_equal_numpy(state, monkeypatch, block, dt):
    S, Q, _ = state
    kw = dict(block=block, dtype=dt, store_transpose=True, weights_dtype=dt)
    monkeypatch.setattr(tb, "_NATIVE_PACK_MIN_NNZ", 1 << 62)
    ref = tb.bcsr_operands_from_state(S, Q, **kw)
    monkeypatch.setattr(tb, "_NATIVE_PACK_MIN_NNZ", 0)
    nat = tb.bcsr_operands_from_state(S, Q, **kw)
    for f in _FIELDS:
        assert _same(getattr(nat, f), getattr(ref, f)), f
    for m in ("s_blocks", "st_blocks"):
        a, b = getattr(nat, m), getattr(ref, m)
        assert a.nrows == b.nrows
        assert _same(a.bcols, b.bcols) and _same(a.blocks, b.blocks), m
    # bcsr_from_csr takes the same route.
    St = scipy.sparse.csr_matrix(S)
    a = tb.bcsr_from_csr(St, block=block, dtype=dt)
    monkeypatch.setattr(tb, "_NATIVE_PACK_MIN_NNZ", 1 << 62)
    b = tb.bcsr_from_csr(St, block=block, dtype=dt)
    assert _same(a.bcols, b.bcols) and _same(a.blocks, b.blocks)


def test_native_packer_guards():
    """An unsorted CSR is packed from a sorted copy and left as it was; the
    weights refuse it; the packer's maps cover every entry."""
    rng = np.random.default_rng(0)
    M = scipy.sparse.random(300, 300, density=0.05, random_state=rng,
                            format="csr")
    M.sort_indices()
    want = builder.bcsr_pack_native(M, (8, 128), return_entry_maps=True)
    # Reverse each row's columns: same matrix, unsorted indices.
    P = M.copy()
    for r in range(P.shape[0]):
        s, e = P.indptr[r], P.indptr[r + 1]
        P.indices[s:e] = P.indices[s:e][::-1].copy()
        P.data[s:e] = P.data[s:e][::-1].copy()
    P.has_sorted_indices = False
    before = P.indices.copy()
    got = builder.bcsr_pack_native(P, (8, 128), return_entry_maps=True)
    np.testing.assert_array_equal(P.indices, before)
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert min(int(m.min()) for m in want[3]) >= 0
    with pytest.raises(ValueError, match="sorted"):
        builder.bcsr_sym_weights_native(P)
    np.testing.assert_array_equal(P.indices, before)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        builder.bcsr_pack_native(M, (8, 128), dtype=torch.float64)
