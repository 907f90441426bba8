"""LP relaxation baseline: assignment-probability matrix P in [0,1]^{Z x K}.

Port of :mod:`sig_sdp_mmw_tpu.models.lrp` (reference ``lrp_solver``,
``sim_src/alg/lrp.py``), whose constraint system (``lrp.py:41-51``) is

    0 <= P <= 1,   sum_z P_zk = 1,
    P_z,i + P_z,j <= 1            for associated pairs (i, j),
    (P S)_zk <= P_zk (h_max_k - S_sum_k) + S_sum_k      (big-M interference)

solved, as in the JAX package, by a fixed number of rounds of
Cimmino-averaged projections onto the four constraint families (the
reference hands it to cvxpy+SCS).  Each round's association correction is
one batched [Z_pad, Kp, Kp] pair-excess evaluation (the JAX package maps it
slot by slot).  Rounding uses the reference's LP variant: natural user
order, slots preferred by decreasing probability (``lrp.py:57-125``); call n
of :meth:`LRPSolver.rounding` fills the unassigned users from the draws'
``lrp_fill``, stream n of ``seed`` (JAX: ``fold_in(PRNGKey(seed), n)``).
"""

from __future__ import annotations

import numpy as np
import torch

from sig_sdp_mmw_torch.core.preprocess import build_mmw_operands
from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.models.rounding import _default_z_pad, _greedy_assign
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.stats import StatsObject


def lrp_solve(state: SigState, Z, *, nit: int, Z_pad: int):
    """[Z_pad, Kp] slot probabilities after ``nit`` projection rounds; rows
    z >= Z and padded users are 0."""
    dtype, device = state.S.dtype, state.S.device
    Zf = torch.as_tensor(Z, dtype=dtype, device=device)
    op = build_mmw_operands(state, Zf)

    mask = op.mask
    zrow = (torch.arange(Z_pad, device=device) < Z)[:, None]   # [Z_pad, 1]
    valid = zrow & mask[None, :]
    Zc = torch.clamp(Zf, min=1.0)

    # S as the reference uses it: dense(S̃)^T (lrp.py:43); (P S)_zk =
    # sum_j P_zj S̃_kj.
    StT = op.St.T
    a_diag = op.S_sum - op.h_max                             # big-M coefficient
    # Row functional for constraint (z, k): sum_j P_zj S̃_kj + P_zk a_k <= S_sum_k.
    norm2 = torch.clamp(torch.sum(op.St * op.St, dim=1) + a_diag ** 2,
                        min=1e-12)
    assoF = ((state.Q != 0) & mask[:, None] & mask[None, :]).to(dtype)
    two_deg = 2.0 * torch.clamp(torch.sum(assoF, dim=1), min=1.0)

    def proj(P):
        # Box.
        P = torch.clamp(P, 0.0, 1.0)
        # Column sums to one over active slots (additive correction + box).
        colsum = torch.sum(torch.where(valid, P, 0.0), dim=0)
        P = P + torch.where(valid, (1.0 - colsum)[None, :] / Zc, 0.0)
        P = torch.clamp(P, 0.0, 1.0)
        # Association pairs P_zi + P_zj <= 1: each violated pair's exact
        # halfspace projection moves both endpoints by excess/2, and user i
        # takes the average over its deg_i pairs (lrp.py:46).
        E = torch.clamp(P[:, :, None] + P[:, None, :] - 1.0, min=0.0) * assoF
        corr = torch.sum(E, dim=2) / two_deg                 # [Z_pad, Kp]
        P = P - torch.where(valid, corr, 0.0)
        P = torch.clamp(P, 0.0, 1.0)
        # Interference big-M rows: halfspace corrections, Cimmino-averaged.
        v = P @ StT + P * a_diag[None, :] - op.S_sum[None, :]   # [Z_pad, Kp]
        exc = torch.clamp(v, min=0.0) / norm2[None, :]
        # Gradient of the functional w.r.t. P row z: S̃_k. + a_k e_k.
        P = P - (exc @ op.St + exc * a_diag[None, :])
        P = torch.clamp(P, 0.0, 1.0)
        return torch.where(valid, P, 0.0)

    P = torch.where(valid, 1.0 / Zc, 0.0).to(dtype)
    for _ in range(nit):
        P = proj(P)
    return P


def lrp_residuals(state: SigState, P, Z) -> dict:
    """Feasibility residuals of P against the reference LP constraint system
    (``lrp.py:41-51``), max-norm per family: a host-side diagnostic."""
    if isinstance(P, torch.Tensor):
        P = P.cpu().numpy()
    P = np.asarray(P, np.float64)
    K = int(state.K)
    Zi = int(Z)
    Pa = P[:Zi, :K]

    box = max(float(np.max(-Pa, initial=0.0)),
              float(np.max(Pa - 1.0, initial=0.0)))
    colsum = float(np.max(np.abs(Pa.sum(axis=0) - 1.0)))

    Q = state.Q.cpu().numpy().astype(np.float64)[:K, :K]
    ii, jj = np.nonzero(Q)
    pair = float(np.max(Pa[:, ii] + Pa[:, jj] - 1.0, initial=0.0))

    S = state.S.cpu().numpy().astype(np.float64)[:K, :K].copy()
    np.fill_diagonal(S, 0.0)
    St = (S - S * (Q != 0)).T                 # S̃ rows as the LP uses them
    S_sum = St.sum(axis=1)
    h = state.h_max.cpu().numpy().astype(np.float64)[:K]
    # (P S̃ᵀ)_zk <= P_zk (h_k - S_sum_k) + S_sum_k, relative to the row scale.
    lhs = Pa @ St.T
    rhs = Pa * (h - S_sum)[None, :] + S_sum[None, :]
    scale = np.maximum(np.abs(h - S_sum) + S_sum, 1e-12)
    interf = float(np.max((lhs - rhs) / scale[None, :], initial=0.0))
    return {"box": box, "colsum": colsum, "pair": pair, "interf": interf}


class LRPSolver(StatsObject):
    """Drop-in for the reference ``lrp_solver`` (``lrp.py:7``)."""

    def __init__(self, nit: int = 100, alpha: float = 1.0, seed: int = 0):
        self.nit = nit
        self.alpha = alpha
        self.seed = seed
        self._n = 0

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState):
        ps_tic = self._get_tic()
        Z_pad = max(_default_z_pad(state), ((Z + 15) // 16) * 16)
        tim = self._get_tim(ps_tic)
        self._add_np_log("lrp_problem_setup", bs_iteration,
                         np.array([Z, state.K, tim]))

        tic = self._get_tic()
        P = lrp_solve(state, float(Z), nit=self.nit, Z_pad=Z_pad)
        tim = self._get_tim(tic, sync=P)
        self._add_np_log("lrp_solve", bs_iteration, np.array([Z, state.K, tim]))
        return True, P

    def rounding(self, Z: int, gX, state: SigState, nattempt: int = 1):
        """LP rounding (``lrp.py:57-125``): natural user order, slots by
        decreasing probability.  (z_vec [K], Z, rem)."""
        self._n += 1
        draws = TorchDraws(self.seed, state.mask.device, stream=self._n)
        z_vec, rem = _lrp_round(state, gX, int(Z), draws, Z_pad=gX.shape[0])
        return z_vec.cpu().numpy()[: state.K], Z, rem


def _lrp_round(state: SigState, P, Z: int, draws, Z_pad: int):
    """(z_vec [Kp] int32, rem) of the LP rounding of P [Z_pad, Kp]."""
    Kp, device = state.Kp, state.mask.device
    order = torch.arange(Kp, device=device)     # natural order (lrp.py:76)
    slot_ok = (torch.arange(Z_pad, device=device) < Z)[:, None]
    # Stable sorts: clipping leaves many P entries at exactly 0 or 1.
    rank_of = torch.argsort(-torch.where(slot_ok, P, -torch.inf), dim=0,
                            stable=True)
    pref = torch.argsort(rank_of, dim=0, stable=True)
    slot_of, rem, assigned = _greedy_assign(state, order[None, :],
                                            pref[None], Z, Z_pad)
    fill = draws.lrp_fill(Kp, Z).to(device)
    z_vec = torch.where(assigned[0], slot_of[0], fill)
    return torch.where(state.mask, z_vec, 0), int(rem[0])
