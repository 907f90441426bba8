"""The plain reference of the binary search over the number of slots Z
(zhouyou-gu/sig-sdp-mmw ``sim_src/alg/binary_search_relaxation.py``): its
window from the state's degrees, and the probe each answer leads to.

:func:`replay` follows a run's probes, answer by answer: it says which Z
the search had to probe next and, once the window closes on a feasible
probe, the Z it had to return.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


def window(S, Q):
    """(lo, hi) of the search on the state (S, Q): lo = the largest number
    of users of one AP (association degree + 1), hi = the largest number of
    other users a user shares a gain with, in either direction, + 2; both
    at least 2, and hi at least lo."""
    Q = scipy.sparse.csr_matrix(Q)
    Q.eliminate_zeros()
    lb = int(np.diff(Q.indptr).max(initial=0)) + 1
    P = scipy.sparse.csr_matrix(S) != 0
    P = (P + P.T).tocsr()
    P.setdiag(False)
    P.eliminate_zeros()
    ub = int(np.diff(P.indptr).max(initial=0)) + 2
    return max(lb, 2), max(ub, 2, lb)


def replay(lo: int, hi: int, probes):
    """Follow the bisection over ``probes`` (a list of (Z, rem), in the
    order probed).  Returns (mismatches, done, Z_fin): the probes whose Z
    is not the one the search had to probe, whether the search had to end
    with the last probe, and the Z it had to return then (None while
    open).  A probe is feasible when its remainder is 0."""
    bad = 0
    for n, (Z, rem) in enumerate(probes):
        mid = (lo + hi) // 2
        bad += int(Z != mid)
        feasible = rem == 0
        if feasible and hi <= lo + 1:
            return bad + (len(probes) - n - 1), n == len(probes) - 1, mid
        if feasible:
            hi = mid
        elif lo < hi:
            lo = mid + 1
        else:
            lo, hi = lo + 1, hi + 1
    return bad, False, None
