"""Exact SDP baseline via ADMM splitting: the oracle role of cvxpy+SCS.

Port of :mod:`sig_sdp_mmw_tpu.models.admm`.  The reference's exact baseline
(``sim_src/alg/sdp_solver.py:115-163``) hands the feasibility SDP

    X >> 0,  diag(X) = 1,  X_ij <= -1/(Z-1) on associated pairs,
    sum_j S̃_kj X_kj (Z-1)/Z <= h_max_k - S_sum_k/Z

to the SCS interior C library; the JAX package re-builds the oracle as a
consensus ADMM over four constraint blocks with exact projections, which
this module keeps operation for operation.  Like SCS under
``max_iters=nit`` (``sdp_solver.py:127``), a finite iteration budget yields
an approximately feasible X; the downstream randomized rounding is the dense
rounding.  The final factor mirrors the reference's rank-trimmed SVD
(``sdp_solver.py:130-132``).

Each iteration's PSD projection is one full ``torch.linalg.eigh`` of the
[Kp, Kp] consensus point (cuSOLVER on the card, which waits for the host
on every call), as the JAX package computes it outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from sig_sdp_mmw_torch.core.preprocess import build_mmw_operands
from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.models.base import SDPSolverBase
from sig_sdp_mmw_torch.utils.stats import StatsObject


def proj_psd(X):
    """Nearest symmetric PSD matrix: eigh of the symmetrized copy, negative
    eigenvalues clipped."""
    w, V = torch.linalg.eigh(0.5 * (X + X.T))
    return (V * torch.clamp(w, min=0.0)[None, :]) @ V.T


def admm_rank(K: int, Z, rank_radio: int) -> int:
    """min(K, (Z-1)·rank_radio), truncated, as the reference
    (``sdp_solver.py:131``)."""
    return min(int(K), int((float(Z) - 1.0) * rank_radio))


def admm_sdp_solve(state: SigState, Z, *, nit: int, rank_pad: int,
                   rank_radio: int = 2):
    """Consensus ADMM over four constraint blocks, each with an exact
    Euclidean projection:

    1. the symmetric PSD cone (:func:`proj_psd`);
    2. ``diag(X) = 1`` (affine: replace the diagonal);
    3. the association cap ``X_ij <= -1/(Z-1)`` (pointwise min, both
       triangles);
    4. the interference row halfspaces ``<St_k, X_k> <= c_k``: with symmetry
       held by block 1, row constraints touch disjoint coordinates, so the
       joint projection is the per-row halfspace formula, exactly.

    Returns (X_half [Kp, rank_pad], the first ``admm_rank`` columns the
    largest-magnitude eigenpairs of X_final as ``V sqrt|w|``; X_final [Kp,
    Kp], the PSD projection of the last consensus point)."""
    Kp, K = state.Kp, state.K
    dtype, device = state.S.dtype, state.S.device
    Zf = torch.as_tensor(float(Z), dtype=dtype, device=device)
    op = build_mmw_operands(state, Zf)

    eyeb = torch.eye(Kp, dtype=torch.bool, device=device)
    m2 = op.mask[:, None] & op.mask[None, :]
    asso = (state.Q != 0) & m2
    fbound = -1.0 / (Zf - 1.0)
    diag_target = torch.where(op.mask, 1.0, 0.0).to(dtype)
    diag_mat = torch.diag(diag_target)

    St = op.St
    St_norm2 = torch.clamp(torch.sum(St * St, dim=1), min=1e-12)   # [Kp]
    c_H = (op.h_max - op.S_sum / Zf) * Zf / (Zf - 1.0)           # row budgets

    def proj_diag(X):
        return torch.where(eyeb, diag_mat, X)

    def proj_asso(X):
        return torch.where(asso, torch.minimum(X, fbound), X)

    def proj_interf(X):
        v = torch.sum(St * X, dim=1)                               # [Kp]
        excess = torch.clamp(v - c_H, min=0.0)
        return X - (excess / St_norm2)[:, None] * St

    projs = (proj_psd, proj_diag, proj_asso, proj_interf)
    nb = len(projs)

    Xbar = diag_mat.clone()
    Us = [torch.zeros((Kp, Kp), dtype=dtype, device=device)
          for _ in range(nb)]
    for _ in range(nit):
        Zs = [p(Xbar - U) for p, U in zip(projs, Us)]
        Xbar = sum(Zi + Ui for Zi, Ui in zip(Zs, Us)) / nb
        Xbar = torch.where(m2, Xbar, 0.0)
        Us = [U + Zi - Xbar for U, Zi in zip(Us, Zs)]

    X_final = proj_psd(Xbar)
    # Rank-trimmed factor (sdp_solver.py:130-132) via eigh (X ~ PSD here).
    w, V = torch.linalg.eigh(X_final)
    order = torch.argsort(-torch.abs(w), stable=True)[:rank_pad]
    w_sel = torch.abs(w[order])
    keep = (torch.arange(rank_pad, device=device)
            < admm_rank(K, Z, rank_radio))[None, :]
    X_half = torch.where(keep, V[:, order] * torch.sqrt(w_sel)[None, :], 0.0)
    X_half = torch.where(op.mask[:, None], X_half, 0.0)
    return X_half, X_final


class ADMMSDPSolver(SDPSolverBase, StatsObject):
    """Drop-in for the reference ``admm_sdp_solver`` (``sdp_solver.py:115``)."""

    def __init__(self, nit: int = 100, rank_radio: int = 2, alpha: float = 1.0):
        SDPSolverBase.__init__(self, nit=nit, rank_radio=rank_radio, alpha=alpha)

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState):
        ps_tic = self._get_tic()
        _, ub = state.degree_bounds()
        rank_pad = min(((max(Z, ub) * self.rank_radio + 15) // 16) * 16,
                       state.Kp - 1)
        tim = self._get_tim(ps_tic)
        self._add_np_log("admm_problem_setup", bs_iteration,
                         np.array([Z, state.K, tim]))

        tic = self._get_tic()
        X_half, _ = admm_sdp_solve(state, float(Z), nit=self.nit,
                                   rank_pad=rank_pad,
                                   rank_radio=self.rank_radio)
        tim = self._get_tim(tic, sync=X_half)
        self._add_np_log("admm_solve", bs_iteration,
                         np.array([Z, state.K, tim]))
        return True, X_half
