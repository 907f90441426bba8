"""Port parity: the block-sparse solve of the sharded cell's layout
(128x128 float32 block-ELL, nit 30, eta 0.05, Z and D_pad as
``tools/sharded_large.py`` sets them, rows padded to a multiple of 256)
given the JAX package's own sketches
(``sig_sdp_mmw_torch.experiments.sharded_ub_draws.JaxSketches``, the
replay the card runs at K=30,000) gives the JAX package's ``ub`` on the
same instance, at cells 20 and 40 (K=1,200 and 4,800).

Tolerance: |Δub| <= 1e-5 (float32 solves, summed in different orders).
"""

import jax
import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
from sig_sdp_mmw_torch.env.large import LargeEnv
from sig_sdp_mmw_torch.experiments.sharded_large import layout_operands
from sig_sdp_mmw_torch.experiments.sharded_ub_draws import JaxSketches
from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
from sig_sdp_mmw_tpu.core.ell import ell_from_scipy
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell as j_solve
from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state as j_ops
from torch_jax_parity import JaxDraws
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

NIT, ETA, BLOCK = 30, 0.05, 128


@pytest.mark.parametrize("cell", [20, 40])
def test_jax_sketches_give_jax_ub(cell):
    S, Q, h = LargeEnv(cell, 75e-4, seed=0).generate_state_csr()
    K = S.shape[0]
    nr = -(-K // (2 * BLOCK)) * 2 * BLOCK
    Z = float(int(np.diff(Q.indptr).max()) + 1 + 4)
    D = ((int(Z) * 2 + 15) // 16) * 16
    key = jax.random.PRNGKey(0)
    draws = JaxDraws(key, NIT)
    sketches = np.stack([draws.sketch(i, (nr, D), torch.float32).numpy()
                         for i in range(NIT)])
    got = mmw_solve_ell(ell_slim_from_csr(S, Q, h, pad_rows_to=nr,
                                          device="cpu"),
                        Z, nit=NIT, eta=ETA, D_pad=D, rank_pad=D,
                        draws=JaxSketches(sketches, "cpu"),
                        bcsr=layout_operands(S, Q, BLOCK, nr, "f32_ell"))
    want = jax.jit(lambda e, k, b: j_solve(
        e, Z, nit=NIT, eta=ETA, D_pad=D, rank_pad=D, key=k, bcsr=b))(
        ell_from_scipy(S, Q, h, pad_rows_to=nr), key,
        j_ops(S, Q, block=BLOCK, pad_rows_to=nr))
    assert abs(float(got.ub_final) - float(want.ub_final)) <= 1e-5
