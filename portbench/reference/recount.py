"""The reference's judgement of an answer, in float64 NumPy.

* :func:`recount` takes an assignment that claims every user a slot and
  recounts, on the reference's own state, what it breaks: the largest
  relative overload of any user's interference budget, and the same-slot
  associated pairs plus the users left without a slot in ``[0, Z)``.
* :func:`state_error` measures how far the state the program derived lies
  from the reference's: the largest relative error of a value, where an
  entry the threshold keeps on one side only counts unless its unthresholded
  ratio lies within ``edge`` of the threshold.
"""

from __future__ import annotations

import numpy as np


def recount(S, Q, h_max, z, Z: int):
    """(overload, broken) of assignment ``z`` with ``Z`` slots on the state
    ``(S, Q, h_max)`` (dense arrays or SciPy sparse matrices, S[k, j] the
    gain of user k at the AP of user j).  ``overload``: max over users j of
    (load_j - h_j) / |h_j|, floored at 0, where load_j sums S[k, j] over the
    other users k in j's slot.  ``broken``: same-slot associated pairs plus
    users whose slot is outside [0, Z)."""
    import scipy.sparse

    z = np.asarray(z).astype(np.int64)
    K = z.shape[0]
    h = np.asarray(h_max, np.float64)
    S = scipy.sparse.coo_matrix(S)
    off = S.row != S.col
    same = off & (z[S.row] == z[S.col])
    load = np.zeros(K, np.float64)
    np.add.at(load, S.col[same], np.asarray(S.data, np.float64)[same])
    over = float(np.max(np.maximum(load - h, 0.0) / np.abs(h), initial=0.0))

    Qc = scipy.sparse.coo_matrix(Q)
    q = (Qc.row < Qc.col) & (Qc.data != 0)
    pairs = int(np.sum(z[Qc.row[q]] == z[Qc.col[q]]))
    outside = int(np.sum((z < 0) | (z >= Z)))
    return over, pairs + outside


def state_error(ref_vals, ref_raw, got_vals, threshold: float,
                edge: float = 1e-4) -> float:
    """Largest relative error of ``got_vals`` against ``ref_vals`` (arrays
    of the same entries; 0 where the threshold dropped an entry).
    ``ref_raw`` holds the unthresholded ratios of the same entries: an
    entry kept on one side only is forgiven when its ratio lies within
    ``edge`` (relative) of ``threshold``, since float32 and float64 may
    round it to either side."""
    ref = np.asarray(ref_vals, np.float64)
    got = np.asarray(got_vals, np.float64)
    raw = np.asarray(ref_raw, np.float64)
    on_edge = np.abs(raw - threshold) <= edge * threshold
    one_side = (ref == 0) != (got == 0)
    scale = np.where(ref != 0, np.abs(ref), threshold)
    err = np.abs(got - ref) / scale
    err = np.where(one_side & on_edge, 0.0, err)
    return float(np.max(err, initial=0.0))
