"""Randomized rounding and the independent feasibility checker on the host
CSR state (port of the native path of
:mod:`sig_sdp_mmw_tpu.models.rounding_ell`).

The greedy scan is sequential pointer-chasing over the interference graph,
so it runs in the shared C++ loop (``csrc/sig_native.cpp::sig_greedy_round``);
the port computes the ordering and slot preferences from torch draws and
hands them to that loop.  The JAX package's on-device greedy and wavefront
roundings of the sparse state follow the same reference greedy trajectory;
they are not ported yet.  The dense path's device rounding is
:mod:`sig_sdp_mmw_torch.models.rounding` (first attempt with remainder 0,
else the last one; this module keeps the best).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rounding_native_csr(Z: int, gX: torch.Tensor, S_csr, Q_csr, h_max, draws,
                        nattempt: int = 10, StT_csr=None
                        ) -> Tuple[np.ndarray, int, int]:
    """Reference rounding with the greedy scan in the native C++ loop.

    Users are visited by decreasing ||gX row||, slots by decreasing inner
    product with each attempt's random unit vectors
    (``draws.rounding_rv``); the first attempt with remainder 0 wins, else
    the best one, whose unassigned users get ``draws.fill``.  Returns
    (z_vec, Z, remainder).
    """
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.native import greedy_round_native

    K = S_csr.shape[0]
    StT = (StT_csr if StT_csr is not None
           else build_st_csr(S_csr, Q_csr).transpose().tocsr())
    Qc = Q_csr.tocsr()
    h = np.asarray(h_max, np.float64)

    D = gX.shape[1]
    norms = torch.linalg.norm(gX, dim=1)[:K]
    user_order = torch.argsort(-norms, stable=True).cpu().numpy()

    best = None
    for a in range(nattempt):
        rv = draws.rounding_rv(a, int(Z), D, gX.dtype)
        rn = torch.linalg.norm(rv, dim=1, keepdim=True)
        rv = torch.where(rn > 0, rv / torch.where(rn > 0, rn, 1.0), 0.0)
        inprod = (rv @ gX.T)[:, :K]                       # [Z, K]
        slot_order = torch.argsort(-inprod, dim=0, stable=True).T
        slot_of, rem = greedy_round_native(
            StT, Qc, h, user_order,
            slot_order.to(torch.int32).contiguous().cpu().numpy(), int(Z))
        if best is None or rem < best[1]:
            best = (slot_of, rem, a)
        if rem == 0:
            break

    slot_of, rem, a = best
    if rem:
        fill = draws.fill(a, K, Z)
        slot_of = np.where(slot_of >= 0, slot_of, fill).astype(np.int32)
    return slot_of, Z, rem


def verify_assignment_csr(S_csr, Q_csr, h_max, z_vec) -> Tuple[bool, int, int]:
    """Independent O(nnz) feasibility checker on the host CSR state.

    Interference load at user j = sum of same-slot S[k, j] over k != j,
    compared with ``h_max[j]``; an association violation is a same-slot
    associated pair.  Returns (feasible, n_interf, n_asso).
    """
    S = S_csr.tocoo()
    z = np.asarray(z_vec).astype(np.int64)
    K = S.shape[0]
    h = np.asarray(h_max, np.float64)

    offd = S.row != S.col
    same = offd & (z[S.row] == z[S.col])
    load = np.zeros(K, np.float64)
    np.add.at(load, S.col[same], S.data[same].astype(np.float64))
    n_interf = int(np.sum(load > h))

    # Association violations on the upper triangle of the symmetrized
    # pattern, so a Q that stores one triangle counts each pair once.
    Qc = Q_csr.tocoo()
    qoff = (Qc.row != Qc.col) & (Qc.data != 0)
    lo = np.minimum(Qc.row[qoff], Qc.col[qoff]).astype(np.int64)
    hi = np.maximum(Qc.row[qoff], Qc.col[qoff]).astype(np.int64)
    pairs = np.unique(lo * K + hi)
    n_asso = int(np.sum(z[pairs // K] == z[pairs % K]))
    return (n_interf == 0 and n_asso == 0), n_interf, n_asso


def default_z_pad_ell(ell, Z: int = None) -> int:
    """Static slot-axis padding of the device rounding: with ``Z``, the
    smallest power of two >= max(Z, 16); else the degree upper bound rounded
    up to a multiple of 16."""
    if Z is not None:
        return 1 << (max(int(Z), 16) - 1).bit_length()
    _, ub = ell.degree_bounds()
    return ((ub + 15) // 16) * 16
