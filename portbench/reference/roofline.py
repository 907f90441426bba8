"""Roofline arithmetic of the block-sparse products, and the H100's
published peaks.

The least time a card could take for ``A @ V`` with a block-sparse ``A``:
the larger of the bytes it must move over the memory rate and its
multiply-adds over the block dtype's peak rate.  Bytes count each real
block once in its stored dtype, V (float32) read once and the float32
output written once; operations count 2 per multiply-add of every real
block.  Real blocks are counted from the operand's sparsity pattern, so
the number is the same whatever kernel computes the product.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W
limit: 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor cores, 67
TFLOP/s in float32 outside them.
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def real_blocks(M, Br: int, Bc: int) -> int:
    """Distinct (row // Br, col // Bc) blocks holding an entry of the SciPy
    matrix ``M``."""
    import scipy.sparse

    c = scipy.sparse.coo_matrix(M)
    ncb = (M.shape[1] + Bc - 1) // Bc
    key = (c.row.astype(np.int64) // Br) * ncb + c.col.astype(np.int64) // Bc
    return int(np.unique(key).size)


def product_bound_s(nblk: int, Br: int, Bc: int, nrows: int, ncols: int,
                    D: int, dtype: str) -> float:
    """Seconds of the least time for one ``A @ V`` with ``nblk`` real
    [Br, Bc] blocks of ``dtype``, V [ncols, D] and out [nrows, D] float32."""
    nbytes = nblk * Br * Bc * ITEMSIZE[dtype] + (ncols + nrows) * D * 4
    flop = 2 * nblk * Br * Bc * D
    return max(nbytes / HBM_BYTES_PER_S, flop / PEAK_FLOPS[dtype])


def default_lanczos_m(eta: float, nit: int) -> int:
    """The MMW solver's Krylov depth for its Gibbs sketch (one operator
    apply per step)."""
    return min(48, max(8, int(math.ceil(8 + 0.6 * math.sqrt(eta * nit)))))


def solve_products(nit: int, eta: float, Z: int, rank_radio: int,
                   rsvd_iters: int = 3, oversample: int = 8) -> list:
    """The products one sparse MMW solve at ``Z`` slots makes, as
    (operand, D, count): in each iteration the Lanczos sketch applies the
    loss operator (S̃, S̃ᵀ and Q once each) at every step and S̃ once more
    for the interference row sums, on the Z*rank_radio active columns; the
    final factorization applies the averaged operator (Q, the S̃ pattern and
    its transpose) 2 + 2*rsvd_iters times on rank + oversample columns."""
    m = default_lanczos_m(eta, nit)
    D = int(Z) * rank_radio
    r = int(Z - 1) * rank_radio + oversample
    n_fac = 2 + 2 * rsvd_iters
    return [("St", D, nit * (m + 1)), ("StT", D, nit * m), ("Q", D, nit * m),
            ("St", r, n_fac), ("StT", r, n_fac), ("Q", r, n_fac)]


def solve_bound_s(blocks: dict, B: int, n: int, dtype: str,
                  products: list) -> float:
    """Seconds of the least time for ``products`` (:func:`solve_products`)
    on operands of ``blocks[name]`` real [B, B] blocks, n rows padded to a
    multiple of B."""
    npad = (n + B - 1) // B * B
    return sum(c * product_bound_s(blocks[name], B, B, npad, npad, D, dtype)
               for name, D, c in products)
