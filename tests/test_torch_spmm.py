"""Port parity: the plain versions of the block-ELL and V-resident SpMM
kernels against the JAX package's Pallas kernels (interpret mode), and the
``row_chunk`` argument of the block-ELL products.

Tolerances: the plain block-ELL product vs ``bcsr_spmm_pallas`` to rtol/atol
1e-5 (the tests/test_ell.py:86-108 standard, both round V to the block dtype
and sum exact products in float32); the flat plain version vs
``bsr_spmm_pallas_vres``: float32 blocks to 1e-5, bfloat16 blocks to 1e-4
of max|out| (as the flat kernel's parity test); chunked vs unchunked: the
block-ELL product exactly (each chunk is the same batched product on fewer
block-rows), the transpose to 1e-6 (its scatter-add sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from sig_sdp_mmw_tpu.ops import bcsr as jb
from sig_sdp_mmw_torch.ops import bcsr as tb
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

_DT = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


@pytest.fixture(scope="module")
def rand512():
    return scipy.sparse.random(512, 512, density=0.05, random_state=0,
                               format="csr")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("block", [(128, 128), (8, 128)])
def test_ell_reference_matches_tpu_kernel(rand512, block, dt):
    """bcsr_spmm_reference (and bcsr_spmm on a CPU tensor) vs
    bcsr_spmm_pallas in interpret mode, 512x512, D=64."""
    jd, td = _DT[dt]
    V = np.random.default_rng(0).standard_normal((512, 64)).astype(
        np.float32)
    j = jb.bcsr_from_csr(rand512, block=block, pad_rows_to=512, dtype=jd)
    want = np.asarray(jb.bcsr_spmm_pallas(j, jnp.asarray(V), interpret=True))
    t = tb.bcsr_from_csr(rand512, block=block, pad_rows_to=512, dtype=td)
    got = tb.bcsr_spmm_reference(t, torch.from_numpy(V)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tb.bcsr_spmm(t, torch.from_numpy(V)).numpy(),
                                  got)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("group", [4, 8])
def test_flat_reference_matches_tpu_vres_kernel(rand512, group, dt):
    """bsr_spmm_flat_reference (and bsr_spmm_vres on a CPU tensor), the
    plain version of the V-resident kernel, vs bsr_spmm_pallas_vres in
    interpret mode."""
    jd, td = _DT[dt]
    V = np.random.default_rng(1).standard_normal((512, 40)).astype(
        np.float32)
    j = jb.bsr_flat_from_csr(rand512, block=128, group=group,
                             dtype=np.dtype(jd))
    want = np.asarray(jb.bsr_spmm_pallas_vres(j, jnp.asarray(V),
                                              interpret=True))
    t = tb.bsr_flat_from_csr(rand512, block=128, group=group, dtype=td)
    got = tb.bsr_spmm_flat_reference(t, torch.from_numpy(V)).numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(
        tb.bsr_spmm_vres(t, torch.from_numpy(V)).numpy(), got)


@pytest.mark.parametrize("chunk", [1, 3, 7])
@pytest.mark.parametrize("block", [(128, 128), (8, 128)])
def test_row_chunk_matches_unchunked(rand512, block, chunk):
    """row_chunk splits the block-rows into chunks (with a remainder chunk
    where it does not divide them): bcsr_spmm exactly, the transpose to
    1e-6, both also against the JAX row_chunk products."""
    t = tb.bcsr_from_csr(rand512, block=block, pad_rows_to=512)
    V = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (512, 24)).astype(np.float32))
    full = tb.bcsr_spmm(t, V)
    np.testing.assert_array_equal(tb.bcsr_spmm(t, V, row_chunk=chunk).numpy(),
                                  full.numpy())
    fullT = tb.bcsr_spmm_transpose(t.bcols, t.blocks, V).numpy()
    gotT = tb.bcsr_spmm_transpose(t.bcols, t.blocks, V,
                                  row_chunk=chunk).numpy()
    np.testing.assert_allclose(gotT, fullT, rtol=1e-6, atol=1e-6)
    j = jb.bcsr_from_csr(rand512, block=block, pad_rows_to=512)
    Vj = jnp.asarray(V.numpy())
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jb.bcsr_spmm(j, Vj, row_chunk=chunk)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        gotT, np.asarray(jb.bcsr_spmm_transpose(j.bcols, j.blocks, Vj,
                                                row_chunk=chunk)),
        rtol=1e-5, atol=1e-5)
