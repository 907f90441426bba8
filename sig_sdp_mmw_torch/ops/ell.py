"""ELL sparse matrix-times-block products (port of
:mod:`sig_sdp_mmw_tpu.ops.ell`).

``out[k, :] = sum_d vals[k, d] * V[cols[k, d], :]``.
"""

from __future__ import annotations

import torch


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             V: torch.Tensor) -> torch.Tensor:
    """[Kp, deg] ELL x [Kp, D] block -> [Kp, D], slot by slot: each step is
    one [Kp]-row gather of V plus a scaled add, so peak memory stays
    O(Kp * D)."""
    acc = torch.zeros_like(V)
    for d in range(cols.shape[1]):
        acc = acc + vals[:, d][:, None] * V[cols[:, d]]
    return acc


def ell_edge_gather_dot(a_i: torch.Tensor, a_j: torch.Tensor,
                        X_half: torch.Tensor) -> torch.Tensor:
    """Per-edge inner products ``<X_half[i], X_half[j]>`` for an edge list —
    the sparse-pattern Gram entries without ever forming X."""
    return torch.sum(X_half[a_i] * X_half[a_j], dim=1)
