"""The block layout the bfloat16 SpMM tile relies on, and the bytes its
bound counts.

The tile (sig_sdp_mmw_torch/ops/kernels/csrc/spmm_tile.cuh, ring_tile_bf16)
skips every slot after a row's first whose column-block is 0.  That is
right only if every packer pads that way: each row's real column-blocks
strictly ascending, and every slot after the first at column-block 0 all
zeros.  One test holds each packer's output to that rule; the other holds
``bytes_needed`` (the bound's byte count) to a count made by hand.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_torch.core.ell import build_st_csr
from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.experiments.bench_flat_spmm import (
    block_height_bytes, bytes_needed, real_slots)
from sig_sdp_mmw_torch.ops import bcsr as tb
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def state():
    return generate_large_state_csr(20, 75e-4, seed=2)   # K = 1,200


def _ell_rows(mat):
    """(bcols, slot holds a nonzero) per block-row of a BlockEll."""
    nz = (mat.blocks != 0).any(dim=3).any(dim=1)
    return list(zip(mat.bcols.numpy(), nz.numpy()))


def _flat_rows(mat):
    """(bcols, slot holds a nonzero) per block-row of a FlatBsr."""
    nz = (mat.blocks.reshape(mat.nsteps, mat.Br, mat.G, mat.Bc) != 0
          ).any(dim=3).any(dim=1).reshape(-1).numpy()
    bc, rp, G = mat.bcols.numpy(), mat.row_ptr.numpy(), mat.G
    return [(bc[rp[r] * G:rp[r + 1] * G], nz[rp[r] * G:rp[r + 1] * G])
            for r in range(mat.Kbr)]


def _q_rows(ops):
    """(bcols, slot receives an edge value) per block-row of the Q layout:
    the solver scatters edge values at ``q_pos`` into zeroed blocks."""
    Kbr, maxblk = ops.q_bcols.shape
    Br, Bc = ops.s_blocks.Brow, ops.s_blocks.B
    pos = ops.q_pos.numpy().astype(np.int64)
    nz = np.zeros((Kbr, maxblk), bool)
    nz[pos // (Bc * maxblk) // Br, (pos // Bc) % maxblk] = True
    return list(zip(ops.q_bcols.numpy(), nz))


def _packed(which, state, monkeypatch):
    S, Q, _ = state
    St = build_st_csr(S, Q)
    if which == "ell-numpy-128":
        return _ell_rows(tb.bcsr_from_csr(St, block=128, dtype=torch.bfloat16))
    if which == "ell-numpy-8x128":
        return _ell_rows(tb.bcsr_from_csr(St, block=(8, 128)))
    if which == "ell-native":
        monkeypatch.setattr(tb, "_NATIVE_PACK_MIN_NNZ", 0)
        return _ell_rows(tb.bcsr_from_csr(St, block=128, dtype=torch.bfloat16))
    ops = tb.bcsr_operands_from_state(S, Q, block=128, dtype=torch.bfloat16,
                                      flat_group=4)
    return {"q": _q_rows(ops), "flat-s": _flat_rows(ops.s_flat),
            "flat-st": _flat_rows(ops.st_flat)}[which]


@pytest.mark.parametrize("which", ["ell-numpy-128", "ell-numpy-8x128",
                                   "ell-native", "q", "flat-s", "flat-st"])
def test_packers_pad_as_the_bf16_tile_assumes(state, monkeypatch, which):
    rows = _packed(which, state, monkeypatch)
    padded = 0
    for bcols, nonzero in rows:
        pad = bcols == 0
        pad[0] = False
        assert not (pad & nonzero).any(), "a padding slot holds a value"
        real = bcols[~pad]
        assert np.all(np.diff(real) > 0), "real blocks not strictly ascending"
        padded += int(pad.sum())
    assert padded > 0   # the operand has padding to skip


def _hand_operand():
    """K=500 (4 block-rows of 128, the last partial): blocks at (block-row,
    column-block) (0,0), (0,2), (2,1), (2,2), (2,3), (3,3); block-row 1 is
    empty."""
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for br, bc in ((0, 0), (0, 2), (2, 1), (2, 2), (2, 3), (3, 3)):
        hi_r, hi_c = min(128, 500 - br * 128), min(128, 500 - bc * 128)
        rows.append(br * 128 + rng.integers(0, hi_r, 40))
        cols.append(bc * 128 + rng.integers(0, hi_c, 40))
    r, c = np.concatenate(rows), np.concatenate(cols)
    M = scipy.sparse.csr_matrix((rng.uniform(0.5, 1.0, r.size), (r, c)),
                                shape=(500, 500))
    return M, r, c


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["ell-128", "ell-8x128", "flat-G4",
                                    "flat-G2"])
def test_bytes_needed_counts_real_blocks(layout, dt):
    M, r, c = _hand_operand()
    D = 48
    if layout.startswith("ell"):
        Br = 8 if layout == "ell-8x128" else 128
        mat = tb.bcsr_from_csr(M, block=(Br, 128), dtype=dt)
    else:
        Br = 128
        mat = tb.bsr_flat_from_csr(M, block=128, group=int(layout[-1]),
                                   dtype=dt)
    # By hand: 6 blocks of 128 rows; at 8 rows, one per distinct
    # (row // 8, column-block) pair of the entries.
    nblk = 6 if Br == 128 else len(set(zip(r // 8, c // 128)))
    assert int(real_slots(mat).sum()) == nblk
    assert real_slots(mat).numel() > nblk   # padding was there to leave out
    assert bytes_needed(mat, D) == (nblk * Br * 128 * dt.itemsize
                                    + 2 * 512 * D * 4)
    assert block_height_bytes(M, (Br,), dt.itemsize)[Br] == \
        nblk * Br * 128 * dt.itemsize
