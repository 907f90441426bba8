"""State preprocessing for the dense MMW solver.

Port of :mod:`sig_sdp_mmw_tpu.core.preprocess`: with static shapes and
masks, what the reference's ``mmw._process_state`` and pattern setup compute
with mutable scipy CSR:

* ``St``        — S tilde: ``S^T`` with associated pairs and diagonal removed;
* ``S_sum``     — row sums of S tilde;
* ``norm_H``    — per-row norms of the interference constraints (1 on padded
  or zero rows, so divisions stay finite);
* ``asso_ut``   — strict upper-triangular association pattern (the F
  constraints, one per associated pair);
* ``xpat``      — the off-diagonal pattern (S tilde symmetrized ∪ Q) on which
  the primal X is materialized;
* the valid-user mask.
"""

from __future__ import annotations

import dataclasses

import torch

from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.utils.tensors import TensorFields


@dataclasses.dataclass(frozen=True)
class MMWOperands(TensorFields):
    St: torch.Tensor        # [Kp, Kp] S tilde (S^T, no assoc, no diag)
    S_sum: torch.Tensor     # [Kp]
    norm_H: torch.Tensor    # [Kp] (1 where masked or zero)
    h_max: torch.Tensor     # [Kp]
    asso_ut: torch.Tensor   # [Kp, Kp] bool, strict upper triangle of Q
    xpat: torch.Tensor      # [Kp, Kp] bool, off-diagonal X pattern
    mask: torch.Tensor      # [Kp] bool valid users
    K: int


def build_mmw_operands(state: SigState, Z) -> MMWOperands:
    """The operands of a solve at ``Z`` slots, on the state's device."""
    Kp, K = state.Kp, state.K
    m = state.mask
    device = m.device
    m2 = m[:, None] & m[None, :]
    eye = torch.eye(Kp, dtype=torch.bool, device=device)
    Zf = torch.as_tensor(Z, dtype=state.S.dtype, device=device)

    asso = state.Q != 0
    St = torch.where(m2 & ~asso & ~eye, state.S.T, 0.0)
    S_sum = torch.sum(St, dim=1)

    # sqrt(rowsum(St^2)) * (Z-1)/(2Z) + |h/K - S_sum/(KZ)|
    row2 = torch.sum(St * St, dim=1)
    norm_H = (torch.sqrt(row2) * (Zf - 1.0) / (2.0 * Zf)
              + torch.abs(state.h_max / K - S_sum / (K * Zf)))
    norm_H = torch.where(m & (norm_H > 0), norm_H, 1.0)

    triu = torch.triu(torch.ones((Kp, Kp), dtype=torch.bool, device=device),
                      diagonal=1)
    asso_ut = asso & triu & m2

    gain_sym = (St != 0) | (St.T != 0)
    xpat = (gain_sym | asso) & ~eye & m2
    return MMWOperands(St=St, S_sum=S_sum, norm_H=norm_H, h_max=state.h_max,
                       asso_ut=asso_ut, xpat=xpat, mask=m, K=K)
