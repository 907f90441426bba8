"""Randomized low-rank factorization (subspace iteration).

Port of :mod:`sig_sdp_mmw_tpu.ops.rsvd`: the replacement for ARPACK
``svds`` in the reference's final factorization ``svds(X_avgd, k) ->
X_half = U sqrt(s)``.  Fixed iteration count, all matmul, QR and one small
``eigh``.  The Gaussian test matrix Ω is the draws object's ``omega``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def randomized_symmetric_lowrank(A: torch.Tensor, rank: int, draws,
                                 oversample: int = 8, iters: int = 3
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``rank`` singular pairs of a symmetric matrix A.

    Returns (U [K, rank], s [rank]) with ``A ~= U diag(s_signed) U^T``; ``s``
    are singular values (absolute eigenvalues), the ``svds`` semantics the
    reference uses.
    """
    K = A.shape[0]
    r = min(rank + oversample, K)
    omega = draws.omega((K, r), A.dtype)
    Q = torch.linalg.qr(A @ omega)[0]
    for _ in range(iters):
        Q = torch.linalg.qr(A @ (A @ Q))[0]
    B = Q.T @ (A @ Q)                       # [r, r] symmetric projection
    B = 0.5 * (B + B.T)
    w, V = torch.linalg.eigh(B)             # ascending
    order = torch.argsort(-torch.abs(w), stable=True)[:rank]
    return Q @ V[:, order], torch.abs(w[order])


def rsvd_half_factor(A: torch.Tensor, rank: int, draws) -> torch.Tensor:
    """``X_half = U sqrt(s)`` — the reference's rounding input factor."""
    U, s = randomized_symmetric_lowrank(A, rank, draws)
    return U * torch.sqrt(s)[None, :]
