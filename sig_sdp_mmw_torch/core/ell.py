"""Static-shape ELL sparse graph container, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.core.ell`.  Every row stores exactly
``deg_pad`` (column, value) slots, padded with (0, 0.0), so a zero value
kills the padded contribution in every gather-accumulate.  The build is
host numpy on the scipy CSR state; the arrays then move to ``device`` once.

Arrays (Kp rows, all padded):

* ``s_cols/s_vals``   [Kp, degS]  — S tilde rows (S^T, association pairs and
  diagonal removed);
* ``st_cols/st_vals`` [Kp, degS]  — its transpose;
* ``a_i/a_j``         [E_pad]     — association upper-tri edge list, with
  ``a_mask``;
* ``q_cols/q_eidx``   [Kp, degQ]  — per-row association neighbours and
  pointers into the edge array;
* ``diag_S``          [Kp]        — own-AP gains;
* ``h_max, mask``     [Kp].
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.utils.tensors import TensorFields, as_tensor


@dataclasses.dataclass(frozen=True)
class EllState(TensorFields):
    s_cols: torch.Tensor   # [Kp, degS] int32
    s_vals: torch.Tensor   # [Kp, degS]
    st_cols: torch.Tensor  # [Kp, degS] int32 (transpose)
    st_vals: torch.Tensor  # [Kp, degS]
    s_xw: torch.Tensor     # [Kp, degS] symmetrization weight (1, 0.5 or 0)
    st_xw: torch.Tensor    # [Kp, degS] same, for the transpose
    a_i: torch.Tensor      # [E_pad] int32
    a_j: torch.Tensor      # [E_pad] int32
    a_mask: torch.Tensor   # [E_pad] bool
    q_cols: torch.Tensor   # [Kp, degQ] int32
    q_eidx: torch.Tensor   # [Kp, degQ] int32 (index into a_* arrays)
    q_mask: torch.Tensor   # [Kp, degQ] bool
    q_gain: torch.Tensor   # [Kp, degQ] S values at association positions
    diag_S: torch.Tensor   # [Kp]
    h_max: torch.Tensor    # [Kp]
    mask: torch.Tensor     # [Kp] bool
    K: int
    # Binary-search bounds computed on the host at build time (-1 = absent),
    # so the search never reads the ELL arrays back from the device.
    lb_cache: int = -1
    ub_cache: int = -1

    @property
    def Kp(self) -> int:
        return self.s_cols.shape[0]

    @property
    def E_pad(self) -> int:
        return self.a_i.shape[0]

    def degree_bounds(self) -> Tuple[int, int]:
        """(lb, ub) for the binary search over Z: lb = max association
        degree + 1; ub = max row count of the stored off-diagonal pattern of
        ``S + S^T`` + 2 (the reference keeps an explicit zero on the
        diagonal after ``setdiag(0)``)."""
        if self.lb_cache >= 0 and self.ub_cache >= 0:
            return max(self.lb_cache, 2), max(self.ub_cache, 2, self.lb_cache)
        mask = self.mask.cpu().numpy()
        lb = self.asso_lower_bound()
        cat = np.concatenate([
            np.where(self.s_vals.cpu().numpy() != 0,
                     self.s_cols.cpu().numpy(), -1),
            np.where(self.st_vals.cpu().numpy() != 0,
                     self.st_cols.cpu().numpy(), -1),
            np.where(self.q_mask.cpu().numpy(), self.q_cols.cpu().numpy(), -1),
        ], axis=1)
        cat.sort(axis=1)
        distinct = (cat >= 0) & np.concatenate(
            [np.ones((cat.shape[0], 1), bool), cat[:, 1:] != cat[:, :-1]],
            axis=1)
        ub = int(distinct.sum(axis=1)[mask].max(initial=0)) + 2
        return max(lb, 2), max(ub, 2, lb)

    def asso_lower_bound(self) -> int:
        """lb = max association degree + 1."""
        if self.lb_cache >= 0:
            return self.lb_cache
        q_deg = self.q_mask.cpu().numpy().sum(axis=1)
        return int(q_deg[self.mask.cpu().numpy()].max(initial=0)) + 1


@dataclasses.dataclass(frozen=True)
class EllSlim(TensorFields):
    """The [Kp] and [E_pad] vectors of :class:`EllState` that the
    block-native solver reads; ``S_sum``/``row2`` are the S̃ row sums and
    squared row sums."""

    S_sum: torch.Tensor   # [Kp]
    row2: torch.Tensor    # [Kp]
    a_i: torch.Tensor     # [E_pad] int32
    a_j: torch.Tensor     # [E_pad] int32
    a_mask: torch.Tensor  # [E_pad] bool
    h_max: torch.Tensor   # [Kp]
    mask: torch.Tensor    # [Kp] bool
    K: int

    @property
    def Kp(self) -> int:
        return self.mask.shape[0]

    @property
    def E_pad(self) -> int:
        return self.a_i.shape[0]


def ell_slim(ell: EllState) -> EllSlim:
    """Slim view of a built EllState (reductions over s_vals on its
    device)."""
    return EllSlim(S_sum=torch.sum(ell.s_vals, dim=1),
                   row2=torch.sum(ell.s_vals * ell.s_vals, dim=1),
                   a_i=ell.a_i, a_j=ell.a_j, a_mask=ell.a_mask,
                   h_max=ell.h_max, mask=ell.mask, K=ell.K)


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _assoc_edges(Q, Kp: int):
    """Association upper-tri edge arrays (a_i, a_j, a_mask) padded to a
    multiple of 8."""
    import scipy.sparse

    Qu = scipy.sparse.triu(Q, k=1).tocoo()
    E = Qu.nnz
    E_pad = _round_up(E, 8)
    a_i = np.zeros(E_pad, np.int32)
    a_j = np.zeros(E_pad, np.int32)
    a_mask = np.zeros(E_pad, bool)
    a_i[:E], a_j[:E], a_mask[:E] = Qu.row, Qu.col, True
    return Qu, a_i, a_j, a_mask


def ell_slim_from_csr(S_csr, Q_csr, h_max, pad_rows_to: Optional[int] = None,
                      dtype=np.float32, device="cpu") -> EllSlim:
    """Build the slim state straight from the scipy CSR pair."""
    S = S_csr.tocsr()
    Q = Q_csr.tocsr()
    K = S.shape[0]
    Kp = pad_rows_to or _round_up(K, 8)
    St = build_st_csr(S, Q)
    S_sum = np.zeros(Kp, dtype)
    row2 = np.zeros(Kp, dtype)
    S_sum[:K] = np.asarray(St.sum(axis=1)).ravel()
    row2[:K] = np.asarray(St.multiply(St).sum(axis=1)).ravel()
    _, a_i, a_j, a_mask = _assoc_edges(Q, Kp)
    hm = np.zeros(Kp, dtype)
    hm[:K] = np.asarray(h_max, dtype)
    mask = np.zeros(Kp, bool)
    mask[:K] = True
    t = torch.from_numpy
    return EllSlim(S_sum=t(S_sum), row2=t(row2), a_i=t(a_i), a_j=t(a_j),
                   a_mask=t(a_mask), h_max=t(hm), mask=t(mask),
                   K=K).to(device)


def _csr_gather(M, rows, cols):
    """Vectorized ``M[rows[i], cols[i]]`` lookup on a sorted-indices CSR via a
    global row-major key search — O(nnz + q log nnz), no per-entry Python."""
    M = M.tocsr()
    M.sort_indices()
    ncol = M.shape[1]
    row_of = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    keys = row_of * ncol + M.indices
    q = np.asarray(rows, np.int64) * ncol + np.asarray(cols, np.int64)
    pos = np.searchsorted(keys, q)
    pos = np.minimum(pos, max(keys.size - 1, 0))
    out = np.zeros(q.size, M.data.dtype)
    if keys.size:
        hit = keys[pos] == q
        out[hit] = M.data[pos[hit]]
    return out


def build_st_csr(S_csr, Q_csr):
    """S tilde as CSR: S^T with association pairs and diagonal removed."""
    S = S_csr.tocsr()
    Q = Q_csr.tocsr()
    ST = S.transpose().tocsr(copy=True)
    Qpat = Q.copy()
    Qpat.data = np.ones_like(Qpat.data)
    St = (ST - ST.multiply(Qpat)).tocsr()
    St.setdiag(0.0)
    St.eliminate_zeros()
    St.sort_indices()
    return St


def ell_from_scipy(S_csr, Q_csr, h_max, pad_rows_to: Optional[int] = None,
                   deg_pad: Optional[int] = None, dtype=np.float32,
                   device="cpu") -> EllState:
    """Build the ELL state from the CSR ``(S, Q, h_max)`` on the host, then
    move it to ``device``."""
    import scipy.sparse

    S = S_csr.tocsr()
    Q = Q_csr.tocsr()
    K = S.shape[0]
    Kp = pad_rows_to or _round_up(K, 8)

    diag_S = np.zeros(Kp, dtype)
    diag_S[:K] = S.diagonal()

    St = build_st_csr(S, Q)
    StT = St.transpose().tocsr()
    StT.sort_indices()

    degS = deg_pad or _round_up(
        max(int(np.diff(St.indptr).max(initial=0)),
            int(np.diff(StT.indptr).max(initial=0))), 8)

    def to_ell(M, deg):
        cols = np.zeros((Kp, deg), np.int32)
        vals = np.zeros((Kp, deg), dtype)
        counts = np.diff(M.indptr)
        if counts.max(initial=0) > deg:
            raise ValueError(f"row degree {counts.max()} exceeds pad {deg}")
        row_of = np.repeat(np.arange(M.shape[0]), counts)
        slot_of = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
        cols[row_of, slot_of] = M.indices
        vals[row_of, slot_of] = M.data
        return cols, vals

    s_cols, s_vals = to_ell(St, degS)
    st_cols, st_vals = to_ell(StT, degS)

    # Symmetrization weights: 1 per directed edge, 0.5 where bidirectional.
    P = St.copy()
    P.data = np.ones_like(P.data)
    B = P.multiply(P.transpose()).tocsr()
    Wm = (P - 0.5 * B).tocsr()
    Wm.sort_indices()
    s_xw = to_ell(Wm, degS)[1]
    WmT = Wm.transpose().tocsr()
    WmT.sort_indices()
    st_xw = to_ell(WmT, degS)[1]

    Qu, a_i, a_j, a_mask = _assoc_edges(Q, Kp)
    E = Qu.nnz

    degQ = _round_up(int(np.diff(Q.indptr).max(initial=0)), 4)
    q_cols = np.zeros((Kp, degQ), np.int32)
    q_eidx = np.zeros((Kp, degQ), np.int32)
    q_mask = np.zeros((Kp, degQ), bool)
    ends = np.concatenate([Qu.row, Qu.col]).astype(np.int64)
    peers = np.concatenate([Qu.col, Qu.row]).astype(np.int64)
    eids = np.concatenate([np.arange(E), np.arange(E)])
    order = np.argsort(ends, kind="stable")
    ends, peers, eids = ends[order], peers[order], eids[order]
    counts = np.bincount(ends, minlength=Kp)
    if counts.max(initial=0) > degQ:
        raise ValueError("association degree exceeds pad")
    starts = np.zeros(Kp + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(ends.size) - starts[ends]
    q_cols[ends, slots] = peers
    q_eidx[ends, slots] = eids
    q_mask[ends, slots] = True
    q_gain = np.zeros((Kp, degQ), dtype)
    q_gain[ends, slots] = _csr_gather(S, ends, peers).astype(dtype)

    hm = np.zeros(Kp, dtype)
    hm[:K] = np.asarray(h_max, dtype)
    mask = np.zeros(Kp, bool)
    mask[:K] = True

    # Binary-search bounds from the host CSR (same semantics as the
    # array-based degree_bounds() fallback).
    Qu_pat = scipy.sparse.triu(Q, k=1).tocsr()
    Qb = (Qu_pat + Qu_pat.T).tocsr()
    Qb.data = np.ones_like(Qb.data)
    lb_cache = int(np.diff(Qb.indptr).max(initial=0)) + 1
    Pp = St.copy()
    Pp.data = np.ones_like(Pp.data)
    U = (Pp + Pp.T + Qb).tocsr()
    ub_cache = int(np.diff(U.indptr).max(initial=0)) + 2

    t = torch.from_numpy
    return EllState(
        s_cols=t(s_cols), s_vals=t(s_vals), st_cols=t(st_cols),
        st_vals=t(st_vals), s_xw=t(s_xw), st_xw=t(st_xw),
        a_i=t(a_i), a_j=t(a_j), a_mask=t(a_mask),
        q_cols=t(q_cols), q_eidx=t(q_eidx), q_mask=t(q_mask),
        q_gain=t(q_gain), diag_S=t(diag_S), h_max=t(hm), mask=t(mask),
        K=K, lb_cache=lb_cache, ub_cache=ub_cache).to(device)


def ell_from_sig_state(state, **kw) -> EllState:
    """Interop from the dense container (testing at small K): the ELL state
    of its valid users, on its device unless ``device`` is given (``kw`` as
    in :func:`ell_from_scipy`)."""
    from sig_sdp_mmw_torch.core.problem import state_to_scipy

    kw.setdefault("device", state.mask.device)
    return ell_from_scipy(*state_to_scipy(state), **kw)


def from_jax_arrays(arrays: Mapping, device="cpu") -> EllState:
    """EllState from the fields of a JAX ``sig_sdp_mmw_tpu.core.ell.EllState``
    given as numpy arrays (a mapping of field name to array; ``K``,
    ``lb_cache`` and ``ub_cache`` as ints)."""
    kw = {}
    for f in dataclasses.fields(EllState):
        v = arrays[f.name]
        kw[f.name] = (int(v) if f.name in ("K", "lb_cache", "ub_cache")
                      else as_tensor(v))
    return EllState(**kw).to(device)
