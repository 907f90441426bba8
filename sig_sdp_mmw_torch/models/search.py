"""Binary search over the number of slots Z.

Port of :mod:`sig_sdp_mmw_tpu.models.search`: the same host loop, copied
as-is (each probe is one solve followed by one rounding).  Faithful to the reference
``binary_search_relaxation`` (``sim_src/alg/binary_search_relaxation.py``):

* degree bounds: lb = max association degree + 1, ub = max degree of S+S^T + 1
  (``:13-29``), with ``force_lower_bound`` / ``force_full_bound`` knobs;
* the search loop including the "both bounds infeasible -> shift the window
  up" case (``:57-67``);
* timing telemetry under the reference's metric keys (``bs_set_bounds``,
  ``bs_search``, ``bs_search_per_it``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sig_sdp_mmw_torch.utils.stats import StatsObject


class BinarySearchRelaxation(StatsObject):
    def __init__(self):
        self.feasibility_check_alg = None
        self.force_lower_bound = False
        self.force_full_bound = False

    def set_bounds(self, state) -> Tuple[int, int]:
        """Accepts any state container exposing ``degree_bounds()`` /
        ``asso_lower_bound()``: the dense
        :class:`sig_sdp_mmw_torch.core.problem.SigState` and the sparse
        :class:`sig_sdp_mmw_torch.core.ell.EllState` both do."""
        if self.force_lower_bound:
            lb = state.asso_lower_bound()
            return lb, lb
        if self.force_full_bound:
            return 1, state.K
        lb, ub = state.degree_bounds()
        # Z=1 makes the simplex encoding 1/(Z-1) singular; the reference never
        # probes it in practice (association cliques force lb >= 2).
        return max(lb, 2), max(ub, 2)

    def run(self, state):
        bd_tic = self._get_tic()
        left, right = self.set_bounds(state)
        tim = self._get_tim(bd_tic)
        self._add_np_log("bs_set_bounds", 0, np.array([left, right, tim]))

        bs_tic = self._get_tic()
        Z, z_vec, rem, it = self.search(left, right, state)
        tim = self._get_tim(bs_tic)
        self._add_np_log("bs_search", 0, np.array([left, right, Z, rem, it, tim]))
        return z_vec, Z, rem

    def search(self, lo: int, hi: int, state):
        """Feasibility bisection over the window [lo, hi], reference
        semantics (``binary_search_relaxation.py:44-72``): a feasible probe
        (rem == 0) shrinks the window from above, an infeasible one from
        below, and if the window collapses while still infeasible — the
        degree bounds were optimistic — the whole window slides up by one
        and probing continues."""
        it = 0
        alg = self.feasibility_check_alg
        while True:
            mid = (lo + hi) // 2
            slv_tic = self._get_tic()
            _, gX = alg.run_with_state(it, mid, state)
            slv_tim = self._get_tim(slv_tic, sync=gX)
            rnd_tic = self._get_tic()
            z_vec, Z, rem = alg.rounding(mid, gX, state)
            rnd_tim = self._get_tim(rnd_tic)
            self._add_np_log("bs_search_per_it", it,
                             np.array([lo, hi, mid, Z, rem, slv_tim, rnd_tim]))
            it += 1
            feasible = rem == 0
            if feasible and hi <= lo + 1:
                # Window closed on a feasible mid: Z found.
                done = True
            else:
                done = False
                if feasible:
                    hi = mid
                elif lo < hi:
                    lo = mid + 1
                else:
                    lo, hi = lo + 1, hi + 1   # collapsed + infeasible: slide up
            self._printalltime(
                f"bs window=[{lo},{hi}] mid={mid} Z={Z} rem={rem}")
            if done:
                return Z, z_vec, rem, it
