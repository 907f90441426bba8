"""ELL sparse matrix-times-block products (port of
:mod:`sig_sdp_mmw_tpu.ops.ell`).

``out[k, :] = sum_d vals[k, d] * V[cols[k, d], :]``.
"""

from __future__ import annotations

import torch


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             V: torch.Tensor) -> torch.Tensor:
    """[n, deg] ELL x [Kp, D] block -> [n, D] (n = Kp, or a run of rows),
    slot by slot: each step is one [n]-row gather of V plus a scaled add,
    so peak memory stays O(n * D)."""
    acc = torch.zeros((cols.shape[0], V.shape[1]), dtype=V.dtype,
                      device=V.device)
    for d in range(cols.shape[1]):
        acc = acc + vals[:, d][:, None] * V[cols[:, d]]
    return acc


def ell_edge_gather_dot(a_i: torch.Tensor, a_j: torch.Tensor,
                        X_half: torch.Tensor) -> torch.Tensor:
    """Per-edge inner products ``<X_half[i], X_half[j]>`` for an edge list —
    the sparse-pattern Gram entries without ever forming X."""
    return torch.sum(X_half[a_i] * X_half[a_j], dim=1)
