"""Scenario batching and the speculative parallel-Z searches (port of
:mod:`sig_sdp_mmw_tpu.parallel.batch`).

* :func:`solve_scenarios_batched` — the MMW solve of every instance of a
  stacked batch of states (the reference's seed loops); with a mesh
  (:mod:`sig_sdp_mmw_torch.parallel.mesh`), the instances are split over
  its batch axis and each is solved with its mesh row's graph axis;
* :class:`ParallelProbeSearch` — solve every candidate Z in [lb, ub] of the
  dense state, round each, and narrow the window to the smallest feasible
  one;
* :class:`ParallelProbeSearchEll` — the same on the sparse (ELL / block)
  backend in waves of ``wave`` candidates, the window narrowed to the gap
  between the largest infeasible and the smallest feasible candidate.

The JAX package runs the candidates of a wave as one ``vmap``, which a mesh
can spread over chips.  The port's probe searches solve them one after
another on one card: at K~100k one probe already fills the card, so a wave
costs about ``wave`` probe-times either way (the JAX docstring says the
same of one chip).  Batching a wave's solves into shared launches is later
work; its roundings already share one sequential scan, a row per candidate
and attempt.  The draws follow the JAX key schedule by role
(:mod:`sig_sdp_mmw_torch.utils.draws`: ``wave``, ``scenario_solve``,
``scenario_round``, ``candidate_round``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.models.mmw import MMWOutput, mmw_solve
from sig_sdp_mmw_torch.models.rounding import _default_z_pad, _rounding_batch
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.stats import StatsObject
from sig_sdp_mmw_torch.utils.tensors import cuda_sync


def stack_states(states: Sequence[SigState]) -> SigState:
    """Stack equal-padded states into one batched SigState [B, ...]."""
    if any(s.Kp != states[0].Kp for s in states):
        raise ValueError("all states must share Kp (use a common pad_to)")
    return SigState(S=torch.stack([s.S for s in states]),
                    Q=torch.stack([s.Q for s in states]),
                    h_max=torch.stack([s.h_max for s in states]),
                    mask=torch.stack([s.mask for s in states]),
                    K=states[0].K)


def _instance(states: SigState, b: int) -> SigState:
    """Instance ``b`` of a stacked state (views), with its bounds cache."""
    return dataclasses.replace(states, S=states.S[b], Q=states.Q[b],
                               h_max=states.h_max[b], mask=states.mask[b])


def solve_scenarios_batched(states: SigState, Z, *, nit: int, eta: float,
                            D_pad: int, rank_pad: int, draws,
                            mesh=None, rank_radio: int = 2,
                            lanczos_m: Optional[int] = None) -> MMWOutput:
    """:func:`mmw_solve` of every instance along the leading batch axis of
    ``states``, instance b with ``draws.scenario_solve(b, B)``; the outputs
    stacked [B, ...].  ``Z`` may be a scalar or a [B] sequence.

    ``mesh`` (:func:`sig_sdp_mmw_torch.parallel.mesh.make_mesh`, every rank
    calling with the same arguments): mesh row r solves instances
    [r*c, (r+1)*c) (c = ceil(B / batch)), each with the row's graph axis,
    and the outputs are gathered over the batch axis, so every rank
    returns the whole stacked output.  Raises when a mesh row would get no
    instance."""
    B = states.S.shape[0]
    Zv = np.broadcast_to(np.asarray(Z, np.float64), (B,))
    graph = batch = None
    mine = range(B)
    if mesh is not None:
        batch, graph = (mesh.axis(mesh.axis_names[0]),
                        mesh.axis(mesh.axis_names[1]))
        mine = range(*batch.rows(B))
    outs = [mmw_solve(_instance(states, b), float(Zv[b]), nit=nit, eta=eta,
                      rank_radio=rank_radio, D_pad=D_pad, rank_pad=rank_pad,
                      draws=draws.scenario_solve(b, B), lanczos_m=lanczos_m,
                      graph=graph)
            for b in mine]
    fields = {f.name: torch.stack([getattr(o, f.name) for o in outs])
              for f in dataclasses.fields(MMWOutput)}
    if batch is not None:
        fields = {k: batch.gather_rows(v, B) for k, v in fields.items()}
    return MMWOutput(**fields)


class ParallelProbeSearch(StatsObject):
    """Solve every candidate Z in [lb, ub] of the dense state; return the
    best feasible one.  Same ``run(state) -> (z_vec, Z, rem)`` contract
    and bound semantics as :class:`sig_sdp_mmw_torch.models.search.
    BinarySearchRelaxation`."""

    def __init__(self, nit: int = 100, eta: float = 0.05, rank_radio: int = 2,
                 nattempt: int = 10, seed: int = 0,
                 lanczos_m: Optional[int] = None,
                 max_probes: Optional[int] = None):
        self.nit = nit
        self.eta = eta
        self.rank_radio = rank_radio
        self.nattempt = nattempt
        self.lanczos_m = lanczos_m
        self.max_probes = max_probes
        self.seed = seed
        self._ncall = 0

    def run(self, state: SigState, draws=None):
        """``draws``: the search's draws (default: stream ``ncall`` of
        ``seed``, as the JAX package folds its key)."""
        from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation

        bs = BinarySearchRelaxation()
        lb, ub = bs.set_bounds(state)
        self._ncall += 1
        if draws is None:
            draws = TorchDraws(self.seed, state.mask.device,
                               stream=self._ncall)

        tic = self._get_tic()
        lo, hi = lb, ub           # lo..hi = window still to resolve
        best = None               # (z_vec, Z) of the smallest feasible so far
        rounds = 0
        while True:
            candidates = np.arange(lo, hi + 1)
            if self.max_probes is not None and candidates.size > self.max_probes:
                candidates = np.unique(
                    np.linspace(lo, hi, self.max_probes).round().astype(int))
            rounds += 1
            z_vecs, rems, Zs = self._probe(state, candidates,
                                           draws.wave(rounds))

            feas = np.where(rems == 0)[0]
            if feas.size:
                i = int(feas[np.argmin(Zs[feas])])
                if best is None or Zs[i] < best[1]:
                    best = (z_vecs[i][: state.K], int(Zs[i]))
                # Refine between the largest infeasible candidate below the
                # best and the best itself.
                below = Zs[(rems != 0) & (Zs < best[1])]
                lo = int(below.max()) + 1 if below.size else lo
                hi = best[1] - 1
                if lo > hi or best[1] == lb:
                    break
                # Every candidate in (lo, hi) probed already: done.
                if np.all(np.isin(np.arange(lo, hi + 1), Zs)):
                    break
            else:
                if best is not None:
                    break
                # Nothing feasible in the window: shift it up, like the
                # reference's both-bounds-infeasible case
                # (binary_search_relaxation.py:65-67).
                lo, hi = hi + 1, hi + max(hi - lo, 1)
                if lo > state.K:
                    break

        tim = self._get_tim(tic)
        self._add_np_log("pp_search", 0, np.array([lb, ub, rounds, tim]))
        if best is not None:
            return best[0], best[1], 0
        # No candidate feasible: the reference's sequential binary search
        # takes over (the JAX package's own last step).
        from sig_sdp_mmw_torch.models.mmw import MMW

        bs.feasibility_check_alg = MMW(nit=self.nit, eta=self.eta,
                                       rank_radio=self.rank_radio)
        return bs.run(state)

    def _probe(self, state: SigState, candidates: np.ndarray, draws):
        """Solve and round every candidate: (z_vecs [n, K], rems [n],
        candidates)."""
        n = candidates.size
        D_pad = ((int(candidates.max()) * self.rank_radio + 15) // 16) * 16
        rank_pad = min(D_pad, state.Kp - 1)
        Z_pad = max(_default_z_pad(state),
                    ((int(candidates.max()) + 15) // 16) * 16)
        # The one state, broadcast over the candidates (views, no copies).
        states = dataclasses.replace(
            state, S=state.S.expand(n, -1, -1), Q=state.Q.expand(n, -1, -1),
            h_max=state.h_max.expand(n, -1), mask=state.mask.expand(n, -1))
        out = solve_scenarios_batched(
            states, candidates.astype(np.float64), nit=self.nit,
            eta=self.eta, D_pad=D_pad, rank_pad=rank_pad, draws=draws,
            rank_radio=self.rank_radio, lanczos_m=self.lanczos_m)
        z_vecs, rems = [], []
        for b in range(n):
            z, r = _rounding_batch(state, out.X_half[b], int(candidates[b]),
                                   draws.scenario_round(b, n), Z_pad,
                                   self.nattempt)
            z_vecs.append(z)
            rems.append(r)
        return (torch.stack(z_vecs).cpu().numpy(),
                torch.stack(rems).cpu().numpy(), candidates)


class ParallelProbeSearchEll(StatsObject):
    """Speculative multi-section Z search on the sparse (ELL / block)
    backend, the large-K counterpart of :class:`ParallelProbeSearch`.

    Each wave probes ``wave`` candidate Z values (an MMW solve and
    ``nattempt`` rounding attempts each, every attempt of every candidate
    in one sequential scan, the JAX attempt loop with its early exit
    replayed on their results), then the window narrows to the gap between
    the largest
    infeasible and the smallest feasible candidate,
    so the search resolves in ~log_{W-1}(window) waves instead of
    log2(window) probes.  It pays only where a wave's probes run in
    parallel; on one card they run one after another (module docstring).

    Same ``run(ell) -> (z_vec, Z, rem)`` contract as
    :class:`sig_sdp_mmw_torch.models.search.BinarySearchRelaxation`.  Each
    wave logs (wave, candidates, solve seconds, rounding seconds) under
    ``pp_wave``.
    """

    def __init__(self, nit: int = 100, eta: float = 0.05, rank_radio: int = 2,
                 nattempt: int = 3, seed: int = 0,
                 lanczos_m: Optional[int] = None, wave: int = 4,
                 use_bcsr: bool = False, spmm_row_chunk: Optional[int] = None,
                 d_pad_cap: Optional[int] = None,
                 wave_segment: Optional[int] = None):
        self.nit = nit
        self.eta = eta
        self.rank_radio = rank_radio
        self.nattempt = nattempt
        self.lanczos_m = lanczos_m
        self.wave = max(2, wave)
        self.use_bcsr = use_bcsr
        self.spmm_row_chunk = spmm_row_chunk
        # Cap on the sketch width D_pad: early waves probe Z near the
        # window's upper bound, the easy feasibility checks, where the full
        # D = Z*rank_radio sketch costs most; the solver's D_act clamp makes
        # a narrower sketch a valid (coarser) probe.
        self.d_pad_cap = d_pad_cap
        # Iterations per segment of a candidate's solve (None: one piece);
        # segments pass the carry and use absolute iteration indices, so
        # they reproduce the single-shot solve.
        self.wave_segment = wave_segment
        self.seed = seed
        self._ncall = 0
        self._bcsr = None

    def prepare(self, ell, S_csr=None, Q_csr=None, block=128, **bcsr_kw):
        """Build the block operands on ``ell``'s device (same contract as
        ``MMWEll.prepare``)."""
        if self.use_bcsr:
            from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state

            if S_csr is None:
                raise ValueError("use_bcsr=True needs the scipy (S, Q) pair")
            self._bcsr = bcsr_operands_from_state(
                S_csr, Q_csr, block=block, device=ell.mask.device, **bcsr_kw)
        return self

    def _solve(self, ell, Z: float, draws, D_pad: int, rank_pad: int):
        """One candidate's MMW solve, in segments of ``wave_segment``
        iterations when set."""
        from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell

        kw = dict(nit=self.nit, eta=self.eta, rank_radio=self.rank_radio,
                  D_pad=D_pad, rank_pad=rank_pad, draws=draws,
                  lanczos_m=self.lanczos_m, bcsr=self._bcsr,
                  spmm_row_chunk=self.spmm_row_chunk)
        ns = self.wave_segment
        if not ns or ns >= self.nit:
            return mmw_solve_ell(ell, Z, **kw)
        c = None
        for i0 in range(0, self.nit, ns):
            c = mmw_solve_ell(ell, Z, carry_in=c, it_start=i0,
                              num_steps=min(ns, self.nit - i0),
                              return_carry=True, **kw)
        return mmw_solve_ell(ell, Z, carry_in=c, it_start=self.nit,
                             num_steps=0, **kw)

    def _wave(self, ell, cands: np.ndarray, draws):
        """Solve and round one wave of candidates: (z_vecs [n, Kp], rems
        [n], solve seconds, rounding seconds)."""
        from sig_sdp_mmw_torch.models.rounding_ell import (
            _rounding_wave_ell, default_z_pad_ell)

        n = cands.size
        zmax = int(cands.max())
        need = max(32, zmax * self.rank_radio)
        D_pad = 1 << (need - 1).bit_length()
        cap = max(((ell.Kp - 1) // 16) * 16, 1)
        if self.d_pad_cap is not None:
            cap = min(cap, self.d_pad_cap)
        D_pad = min(D_pad, cap)
        rank_pad = min(D_pad, ell.Kp - 1)
        Z_pad = default_z_pad_ell(ell, zmax)

        t0 = time.time()
        X = [self._solve(ell, float(Z), draws.scenario_solve(i, n), D_pad,
                         rank_pad).X_half for i, Z in enumerate(cands)]
        cuda_sync(X)
        t1 = time.time()
        # Every attempt of every candidate in one scan (entry (i, a) is
        # candidate i's attempt a), then the JAX attempt loop replayed on
        # them.
        zs, rs = _rounding_wave_ell(
            ell, X, cands, [[draws.candidate_round(a, i, n)
                             for a in range(self.nattempt)]
                            for i in range(n)], Z_pad)
        zs, rs = zs.cpu().numpy(), rs.cpu().numpy()
        best_z = best_rem = None
        for attempt in range(self.nattempt):
            z_vecs, rems = zs[:, attempt], rs[:, attempt]
            if best_rem is None:
                best_z, best_rem = z_vecs, rems
            else:
                better = rems < best_rem
                best_z = np.where(better[:, None], z_vecs, best_z)
                best_rem = np.minimum(rems, best_rem)
            if best_rem[0] == 0:
                # cands ascend: once the smallest is feasible nothing in
                # this wave can improve the answer.  Larger candidates keep
                # their full budget otherwise (the sequential reference
                # grants every probe all attempts).
                break
        return best_z, best_rem, t1 - t0, time.time() - t1

    def run(self, ell, draws=None):
        """``draws``: the search's draws (default: stream ``ncall`` of
        ``seed``, as the JAX package folds its key)."""
        lb, ub = ell.degree_bounds()
        self._ncall += 1
        if draws is None:
            draws = TorchDraws(self.seed, ell.mask.device, stream=self._ncall)

        tic = self._get_tic()
        probed = {}               # Z -> (rem, z_vec)
        lo, hi = lb, ub
        waves = 0
        best = None               # (Z, z_vec) smallest feasible
        while True:
            cands = np.unique(np.linspace(lo, hi, self.wave).round()
                              .astype(int))
            cands = cands[~np.isin(cands, list(probed))]
            if cands.size == 0:
                break
            waves += 1
            z_vecs, rems, solve_s, round_s = self._wave(ell, cands,
                                                        draws.wave(waves))
            self._add_np_log("pp_wave", waves, np.array(
                [cands.size, solve_s, round_s]))
            for i, Z in enumerate(cands):
                probed[int(Z)] = (int(rems[i]), z_vecs[i])
            feas = sorted(Z for Z, (r, _) in probed.items() if r == 0)
            if feas:
                bz = feas[0]
                best = (bz, probed[bz][1])
                below = [Z for Z, (r, _) in probed.items()
                         if r != 0 and Z < bz]
                lo = max(below) + 1 if below else lo
                hi = bz - 1
                if lo > hi:
                    break
            else:
                # Everything infeasible: slide the window up (the
                # reference's both-bounds-infeasible case).
                lo, hi = hi + 1, hi + max(hi - lo, 1)
                if lo > ell.K:
                    break
            self._printalltime(
                f"pp-ell wave={waves} window=[{lo},{hi}] "
                f"probed={sorted(probed)} best={best[0] if best else None}")

        tim = self._get_tim(tic)
        self.probed = {Z: r for Z, (r, _) in probed.items()}
        self._add_np_log("pp_search", 0, np.array([lb, ub, waves, tim]))
        if best is None:
            raise RuntimeError("speculative search found no feasible Z up "
                               f"to K={ell.K}")
        return np.asarray(best[1])[: ell.K], best[0], 0
