"""Randomized rounding of the dense path: SDP factor -> slot assignment,
plus the independent feasibility checker.

Port of :mod:`sig_sdp_mmw_tpu.models.rounding` (reference greedy rounding,
``sim_src/alg/sdp_solver.py:18-107``), on the state's device:

* users are visited one by one in decreasing ``||gX_k||`` order (a Python
  loop of ``K`` steps over tensors, indexed with device tensors so it never
  waits for the card); at each step every candidate slot's feasibility is
  one masked [Z_pad, Kp] evaluation, and the user takes the first feasible
  slot in its preference order;
* the ``nattempt`` attempts (the reference's serial retries, vmapped in the
  JAX package) are a leading batch dimension, [A, Z_pad, Kp];
* the first attempt with remainder 0 is kept, else the **last** attempt;
  its unassigned users take one shared fallback draw over all Kp users.
  This is not the native path's rule (best attempt, a fill per attempt,
  :mod:`sig_sdp_mmw_torch.models.rounding_ell`), and it shares no code
  with it.

:func:`verify_assignment` is the independent numpy checker: ``remainder ==
0`` from rounding must imply that it passes.

Spans (:func:`sig_sdp_mmw_torch.utils.profiling.span`): ``rounding.round``
around a rounding (``attempts``, ``rem``), ``rounding.verify`` around the
checker.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.utils.profiling import span

_INT_MAX = torch.iinfo(torch.int32).max


def _greedy_assign(state: SigState, order, pref, Z: int, Z_pad: int):
    """Greedy user-major assignment of A attempts at once.

    Args:
      state: problem state (S's diagonal is removed here, as in the
        reference).
      order: [A, Kp] user visit order (padded users last).
      pref: [A, Z_pad, Kp] slot preference rank per user (0 = most
        preferred).
      Z: number of usable slots.

    Returns (slot_of [A, Kp] int32 with -1 for unassigned users, remainder
    [A], assigned [A, Kp] bool).
    """
    Kp = state.Kp
    A = order.shape[0]
    dtype, device = state.S.dtype, state.S.device
    eye = torch.eye(Kp, dtype=torch.bool, device=device)
    S = torch.where(eye, 0.0, state.S)          # setdiag(0)
    Q = state.Q
    Snz = S != 0.0
    Qnz = Q != 0.0
    h_max = state.h_max[None, None, :]
    slots = torch.arange(Z_pad, device=device)
    slot_ok = (slots < Z)[None, :]                              # [1, Z_pad]
    users = torch.arange(Kp, device=device)
    rows = torch.arange(A, device=device)

    slot_of = torch.full((A, Kp), -1, dtype=torch.int32, device=device)
    gain_sum = torch.zeros((A, Z_pad, Kp), dtype=dtype, device=device)
    asso_sum = torch.zeros((A, Z_pad, Kp), dtype=dtype, device=device)
    for kk in range(state.K):
        k = order[:, kk]                                        # [A]
        s_row = S[k][:, None, :]                                # [A, 1, Kp]
        q_row = Q[k][:, None, :]
        self_hot = (users[None, :] == k[:, None])[:, None, :]
        slot_eq = slot_of[:, None, :] == slots[None, :, None]   # [A, Z_pad, Kp]
        # Interference: same-slot assigned S-neighbours and self.
        chkH = (slot_eq & Snz[k][:, None, :]) | self_hot
        okH = ~torch.any(chkH & (gain_sum + s_row > h_max), dim=2)
        # Association: same-slot associated users and self.
        chkA = (slot_eq & Qnz[k][:, None, :]) | self_hot
        okA = ~torch.any(chkA & (asso_sum + q_row >= 1.0), dim=2)

        feas = okH & okA & slot_ok & state.mask[k][:, None]     # [A, Z_pad]
        cost = torch.where(feas, pref[rows, :, k], _INT_MAX)
        z_best = torch.argmin(cost, dim=1)                      # first min
        got = feas[rows, z_best]
        zhot = ((slots[None, :] == z_best[:, None]) & got[:, None])[:, :, None]
        gain_sum = gain_sum + torch.where(zhot, s_row, 0.0)
        asso_sum = asso_sum + torch.where(zhot, q_row, 0.0)
        slot_of[rows, k] = torch.where(got, z_best.to(torch.int32), -1)

    assigned = slot_of >= 0
    remainder = torch.sum(~assigned & state.mask[None, :], dim=1)
    return slot_of, remainder, assigned


def _one_attempt(state: SigState, gX, randv, Z: int, Z_pad: int):
    """A attempts of the reference rounding, one per [Z_pad, D] slice of
    ``randv`` [A, Z_pad, D]."""
    A = randv.shape[0]
    # User order: decreasing ||gX row||; padded users last.
    norms = torch.linalg.norm(gX, dim=1)
    order = torch.argsort(-torch.where(state.mask, norms, -torch.inf),
                          stable=True)
    # Slot preference: decreasing inner product; slots >= Z last.
    inprod = randv @ gX.T                                       # [A, Z_pad, Kp]
    slot_ok = (torch.arange(Z_pad, device=gX.device) < Z)[None, :, None]
    rank_of = torch.argsort(-torch.where(slot_ok, inprod, -torch.inf), dim=1,
                            stable=True)
    pref = torch.argsort(rank_of, dim=1, stable=True)
    return _greedy_assign(state, order[None, :].expand(A, -1), pref, Z,
                          Z_pad)


def _rounding_batch(state: SigState, gX, Z: int, draws, Z_pad: int,
                    nattempt: int):
    """(z_vec [Kp] int32, remainder) on the state's device, without a host
    sync."""
    D = gX.shape[1]
    dtype = state.S.dtype
    rv = torch.stack([draws.dense_rounding_rv(a, Z_pad, D, dtype)
                      for a in range(nattempt)])                # [A, Z_pad, D]
    # Zero inactive factor dims so unit-norm is over the active subspace.
    active = torch.any(gX != 0.0, dim=0)[None, None, :]
    rv = torch.where(active, rv, 0.0)
    rn = torch.linalg.norm(rv, dim=2, keepdim=True)
    rv = torch.where(rn > 0, rv / torch.where(rn > 0, rn, 1.0), 0.0)
    slots, rems, assigned = _one_attempt(state, gX.to(dtype), rv, Z, Z_pad)

    # First attempt with remainder 0, else the last attempt.
    ok = rems == 0
    pick = torch.where(torch.any(ok), torch.argmax(ok.to(torch.int32)),
                       nattempt - 1).view(1)
    # Random fallback for the unassigned users: one draw over all users.
    fill = draws.dense_fill(state.Kp, Z)
    z_vec = torch.where(assigned.index_select(0, pick)[0],
                        slots.index_select(0, pick)[0], fill)
    z_vec = torch.where(state.mask, z_vec, 0)
    return z_vec, rems.index_select(0, pick)[0]


def rounding(Z: int, gX, state: SigState, draws, nattempt: int = 10,
             Z_pad: Optional[int] = None) -> Tuple[np.ndarray, int, int]:
    """Reference-compatible entry (``sdp_solver.py:18``): returns (z_vec,
    Z, remainder) with z_vec a host ndarray of length K.  ``draws``: the
    random draws (``dense_rounding_rv``, ``dense_fill``)."""
    if Z_pad is None:
        Z_pad = _default_z_pad(state)
    with span("rounding.round", Z=Z, attempts=nattempt) as sp:
        z_vec, rem = _rounding_batch(state, gX, int(Z), draws, Z_pad,
                                     nattempt)
        z_host, rem = z_vec.cpu().numpy()[: state.K], int(rem)
        sp.set(rem=rem)
    return z_host, Z, rem


def rounding_one_attempt(Z: int, gX, state: SigState, draws,
                         Z_pad: Optional[int] = None):
    """Single-attempt variant (reference ``rounding_one_attempt``)."""
    return rounding(Z, gX, state, draws, nattempt=1, Z_pad=Z_pad)


def _default_z_pad(state: SigState) -> int:
    _, ub = state.degree_bounds()
    return ((ub + 15) // 16) * 16


# ---------------------------------------------------------------------------
# Independent feasibility checker (the test oracle)
# ---------------------------------------------------------------------------

def verify_assignment(state: SigState, z_vec) -> Tuple[bool, int, int]:
    """Check the two scheduling constraints directly on an assignment.

    * interference: for every user j, the summed same-slot gain load at j's
      AP must not exceed ``h_max[j]``;
    * association: no two associated users share a slot.

    Returns (ok, n_interference_violations, n_association_violations).
    """
    with span("rounding.verify"):
        return _verify(state, z_vec)


def _verify(state: SigState, z_vec):
    K = state.K
    S = state.S.cpu().numpy().astype(np.float64)[:K, :K].copy()
    Q = state.Q.cpu().numpy().astype(np.float64)[:K, :K]
    h = state.h_max.cpu().numpy().astype(np.float64)[:K]
    np.fill_diagonal(S, 0.0)
    z = np.asarray(z_vec)[:K]

    same = z[None, :] == z[:, None]
    np.fill_diagonal(same, False)
    load = (S * same).sum(axis=0)           # column j: sum of same-slot rows
    n_interf = int(np.sum(load > h))
    n_asso = int(np.sum((Q != 0) & same) // 2)
    return (n_interf == 0 and n_asso == 0), n_interf, n_asso
