"""Port parity: block-sparse packers and products
(sig_sdp_mmw_torch.ops.bcsr vs sig_sdp_mmw_tpu.ops.bcsr).

The packers must give the JAX arrays exactly (bfloat16 compared bit for
bit); the products must agree to float32 round-off.  The flat block-CSR
plain version is held against the TPU kernel in interpret mode; the CUDA
kernel's own tests are in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_tpu.core.ell import build_st_csr
from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
from sig_sdp_mmw_tpu.ops import bcsr as jb
from sig_sdp_mmw_torch.ops import bcsr as tb
from torch_jax_parity import jax_fields, to_torch
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

_DT = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


def _equal(t: torch.Tensor, a) -> None:
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        assert a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert t.dtype == to_torch(a).dtype, (t.dtype, a.dtype)
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.fixture(scope="module")
def state():
    return generate_large_state_csr(10, 75e-4, seed=2)


@pytest.fixture(scope="module")
def rand512():
    return scipy.sparse.random(512, 512, density=0.05, random_state=0,
                               format="csr")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("block", [(128, 128), (8, 128)])
def test_block_ell_packer_matches_jax(rand512, block, dt):
    jd, td = _DT[dt]
    j = jb.bcsr_from_csr(rand512, block=block, pad_rows_to=512, dtype=jd)
    t = tb.bcsr_from_csr(rand512, block=block, pad_rows_to=512, dtype=td)
    assert t.nrows == j.nrows
    _equal(t.bcols, j.bcols)
    _equal(t.blocks, j.blocks)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("group", [4, 8])
def test_flat_packer_matches_jax(state, group, dt):
    jd, td = _DT[dt]
    St = build_st_csr(*state[:2])
    j = jb.bsr_flat_from_csr(St, block=128, group=group, dtype=np.dtype(jd))
    t = tb.bsr_flat_from_csr(St, block=128, group=group, dtype=td)
    assert (t.nrows, t.G, t.nsteps) == (j.nrows, j.G, j.nsteps)
    for name in ("brows", "bcols", "blocks"):
        _equal(getattr(t, name), getattr(j, name))
    brows = t.brows.numpy()
    for r in range(t.Kbr):
        assert np.all(brows[t.row_ptr[r]:t.row_ptr[r + 1]] == r)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_operands_match_jax(state, dt):
    S, Q, _ = state
    jd, td = _DT[dt]
    j = jb.bcsr_operands_from_state(S, Q, block=128, dtype=jd,
                                    store_transpose=True, flat_group=4)
    t = tb.bcsr_operands_from_state(S, Q, block=128, dtype=td,
                                    store_transpose=True, flat_group=4)
    jf = jax_fields(j)
    for name in ("g_src", "g_dst", "w_edge", "s_pos", "q_bcols", "q_pos",
                 "q_eidx"):
        _equal(getattr(t, name), jf[name])
    for name in ("s_blocks", "st_blocks", "s_flat", "st_flat"):
        for k, v in jf[name].items():
            if k == "nrows":
                assert getattr(t, name).nrows == v
            else:
                _equal(getattr(getattr(t, name), k), v)
    # Carried across from the JAX arrays, the operands are the same again.
    c = tb.from_jax_arrays(jf)
    _equal(c.s_flat.row_ptr, t.s_flat.row_ptr.numpy())
    _equal(c.st_blocks.blocks, jf["st_blocks"]["blocks"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 40])
def test_flat_reference_matches_tpu_kernel(rand512, D, dt):
    """bsr_spmm_flat_reference vs bsr_spmm_pallas_flat (interpret mode):
    f32 blocks to 1e-5; bf16 blocks to 1e-4 of max|out| (both round V to
    bf16 and sum the exact products in float32, in different orders)."""
    jd, td = _DT[dt]
    V = np.random.default_rng(1).standard_normal((512, D)).astype(np.float32)
    j = jb.bsr_flat_from_csr(rand512, block=128, group=4, dtype=np.dtype(jd))
    want = np.asarray(jb.bsr_spmm_pallas_flat(j, jnp.asarray(V),
                                              interpret=True))
    t = tb.bsr_flat_from_csr(rand512, block=128, group=4, dtype=td)
    got = tb.bsr_spmm_flat(t, torch.from_numpy(V)).numpy()
    assert got.dtype == np.float32
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("block", [(128, 128), (8, 128)])
def test_block_products_match_jax(rand512, block):
    rng = np.random.default_rng(2)
    j = jb.bcsr_from_csr(rand512, block=block, pad_rows_to=512)
    t = tb.bcsr_from_csr(rand512, block=block, pad_rows_to=512)
    V = rng.standard_normal((512, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tb.bcsr_spmm(t, torch.from_numpy(V)).numpy(),
        np.asarray(jb.bcsr_spmm(j, jnp.asarray(V))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tb.bcsr_spmm_transpose(t.bcols, t.blocks, torch.from_numpy(V)).numpy(),
        np.asarray(jb.bcsr_spmm_transpose(j.bcols, j.blocks, jnp.asarray(V))),
        rtol=1e-5, atol=1e-5)
    # and both are A @ V / A^T @ V
    A = rand512.toarray()
    np.testing.assert_allclose(tb.bcsr_spmm(t, torch.from_numpy(V)).numpy(),
                               A @ V, rtol=1e-4, atol=1e-4)


def test_edge_gram_accum_matches_jax(state):
    S, Q, _ = state
    j = jb.bcsr_operands_from_state(S, Q, block=128)
    t = tb.bcsr_operands_from_state(S, Q, block=128)
    nr = t.s_blocks.nrows
    X = np.random.default_rng(3).standard_normal((nr, 16)).astype(np.float32)
    acc0 = np.random.default_rng(4).standard_normal(t.nnz + 1).astype(
        np.float32)
    want = np.asarray(jb.bcsr_edge_gram_accum(
        j.s_blocks.bcols, jnp.asarray(X).reshape(-1, 128, 16),
        jnp.asarray(X).reshape(-1, 128, 16), j.g_src, j.g_dst,
        jnp.asarray(acc0), jnp.float32(0.5)))
    Xt = torch.from_numpy(X)
    got = tb.bcsr_edge_gram_accum(
        t.s_blocks.bcols, Xt.reshape(-1, 128, 16), Xt.reshape(-1, 128, 16),
        t.g_src, t.g_dst, torch.from_numpy(acc0.copy()), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_orders_match_jax():
    locs = np.random.default_rng(5).uniform(0, 400, (500, 2))
    np.testing.assert_array_equal(tb.hilbert_order(locs),
                                  jb.hilbert_order(locs))
    np.testing.assert_array_equal(tb.spatial_order(locs, 20.0),
                                  jb.spatial_order(locs, 20.0))
