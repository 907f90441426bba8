"""The sharded path's pieces on the card: the kernels on row shards
against their plain versions, the transpose product repeating bit for bit
(no atomics), and a graph-sharded block solve over 2 gloo ranks sharing
the card against the same solve in one process.

Tolerances: kernel vs plain 1e-5 of max|out| (chip_smoke.py's); the
transpose product on the card against the CPU the same; the sharded solve
against one process, sharded_large's ``equal`` (|Δub| and the
sign-aligned max|ΔX_half| below 1e-3).  (The CPU's draws are not the
card's, so the solve is not held to the CPU.)

This file imports no jax, so it runs on a CUDA machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.ops import bcsr as tb


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def state():
    return generate_large_state_csr(10, 75e-4, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(8, 8), 32, 128])
def test_kernels_on_row_shards(state, block, dtype):
    _need_card()
    S, Q, _ = state
    ops = tb.bcsr_operands_from_state(S, Q, block=block, dtype=dtype,
                                      store_transpose=True, flat_group=4)
    gen = torch.Generator().manual_seed(0)
    V = torch.randn((ops.s_blocks.nrows, 24), generator=gen)
    for g in range(3):
        sh = tb.shard_rows(ops, g, 3)
        for mat, fn, plain in ((sh.s_flat, tb.bsr_spmm_flat,
                                tb.bsr_spmm_flat_reference),
                               (sh.st_blocks, tb.bcsr_spmm,
                                tb.bcsr_spmm_reference)):
            want = plain(mat, V)
            got = fn(mat.to("cuda"), V.cuda()).cpu()
            assert got.shape == (mat.nrows, 24)
            tol = 1e-5 * float(want.abs().max())
            assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_transpose_product_repeats_bit_for_bit(state):
    _need_card()
    S, Q, _ = state
    sb = tb.bcsr_operands_from_state(S, Q, block=32,
                                     device="cuda").s_blocks
    V = torch.randn((sb.nrows, 48), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    a = tb.bcsr_spmm_transpose(sb.bcols, sb.blocks, V)
    for _ in range(3):
        assert torch.equal(tb.bcsr_spmm_transpose(sb.bcols, sb.blocks, V), a)
    want = tb.bcsr_spmm_transpose(sb.bcols.cpu(), sb.blocks.cpu(), V.cpu())
    assert float((a.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_sharded_solve_on_the_card():
    """2 gloo ranks sharing the card: every operand there, the answer equal
    to the one-process solve, every rank the same bits, both kernels
    launched on each rank's row shard."""
    _need_card()
    from sig_sdp_mmw_torch.experiments import sharded_large

    rec = sharded_large.main(cell=8, nit=10, block=16, graph=2,
                             layouts=("bf16_flat",), device="cuda",
                             backend="gloo")["bf16_flat"]
    assert rec["operand_devices"] == ["cuda"] and rec["equal"]
    assert rec["ranks_bit_equal"] and rec["rounding_rem"] == 0
    assert all(n["bsr_spmm_flat"] > 0 and n["bcsr_spmm"] > 0
               for n in rec["launches_per_rank"])
