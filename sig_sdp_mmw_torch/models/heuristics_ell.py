"""Greedy scheduling heuristics on the sparse ELL state, the large-K
baselines (port of :mod:`sig_sdp_mmw_tpu.models.heuristics_ell`).

They re-derive the reference heuristics (``sim_src/alg/gm.py:8-200``) on
:class:`sig_sdp_mmw_torch.core.ell.EllState`, so the 100k-link pipeline has
comparison points at its own Z.

Slot-major reference, user-major implementation: the reference packs slot
by slot, scanning users in score order within each slot (``gm.py:24-58``).
With a deterministic score order and lowest-slot-first preference, the
user-major greedy (each user takes the lowest feasible slot given all
higher-ranked users' assignments) reaches the same assignment, by induction
over the score order.  The feasibility scan is the ELL rounding's
:func:`sig_sdp_mmw_torch.models.rounding_ell._greedy_assign_ell` (K
sequential user steps on the state's device).

Random draws come from a draws object by role (``score_fill``;
``rand_order``, ``rand_pref``, ``rand_fill``), by default
:class:`sig_sdp_mmw_torch.utils.draws.TorchDraws` seeded as the JAX package
seeds its keys (777 for the score heuristics, 4242 for MAX_RAND).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.models.rounding_ell import (_greedy_assign_ell,
                                                   default_z_pad_ell)
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.stats import StatsObject
from sig_sdp_mmw_torch.utils.tensors import index_sum_in_order


def incoming_gain_scores(ell) -> torch.Tensor:
    """MAX_GAIN rank: total incoming interference per user, the row sums of
    S^T with a zero diagonal (``gm.py:18``).  The ELL state strips
    association-pair gains from S̃, so they are added back from
    ``q_gain``."""
    # s_vals row k holds S[j, k] for the non-association in-neighbours j.
    base = torch.sum(ell.s_vals, dim=1)
    # Many users share an association in-neighbour, so the gains are added
    # to it in a fixed order (the JAX package's scatter-add; masked entries
    # add zero and are left out): the rank repeats bit for bit on the card.
    real = ell.q_mask.reshape(-1)
    asso_in = index_sum_in_order(ell.Kp, ell.q_cols.reshape(-1)[real],
                                 ell.q_gain.reshape(-1)[real])
    return torch.where(ell.mask, base + asso_in, 0.0)


def asso_degree_scores(ell) -> torch.Tensor:
    """MAX_ASSO rank: association degree (``gm.py:81``)."""
    return torch.where(ell.mask, torch.sum(ell.q_mask, dim=1),
                       0).to(torch.float32)


def _pack_by_scores_ell(ell, scores, Z: int, draws, Z_pad: int):
    """Deterministic score order + lowest-slot-first preference, the
    reference slot-major greedy (module docstring).  (z_vec [Kp], ZZ,
    rem)."""
    order = torch.argsort(-torch.where(ell.mask, scores, -torch.inf),
                          stable=True)
    pref = torch.arange(Z_pad, dtype=torch.int32, device=ell.mask.device
                        )[:, None].expand(Z_pad, ell.Kp)
    slot_of, rem, assigned = _greedy_assign_ell(ell, order, pref, Z, Z_pad)
    rem = int(rem)
    # Slots fill lowest first, so on success the used-slot count is the
    # reference's ZZ (gm.py:57-58).
    ZZ = (int(torch.max(torch.where(ell.mask, slot_of, -1))) + 1 if rem == 0
          else int(Z))
    fill = draws.score_fill(ell.Kp, ZZ).to(slot_of.device)
    z_vec = torch.where(assigned, slot_of, fill)
    return torch.where(ell.mask, z_vec, 0), ZZ, rem


def _pack_random_ell(ell, Z: int, draws, Z_pad: int):
    """MAX_RAND (``gm.py:131-200``): a random user order and random slot
    preferences, the same feasibility checks.  (z_vec [Kp], rem)."""
    device = ell.mask.device
    base = torch.argsort((~ell.mask).to(torch.int8), stable=True)
    order = draws.rand_order(base).to(device)
    pref_scores = draws.rand_pref(Z_pad, ell.Kp, torch.float32).to(device)
    pref = torch.argsort(torch.argsort(-pref_scores, dim=0, stable=True),
                         dim=0, stable=True)
    slot_of, rem, assigned = _greedy_assign_ell(ell, order, pref, Z, Z_pad)
    fill = draws.rand_fill(ell.Kp, Z).to(device)
    z_vec = torch.where(assigned, slot_of, fill)
    return torch.where(ell.mask, z_vec, 0), int(rem)


def _z_pad_for(ell, Z: int) -> int:
    return max(default_z_pad_ell(ell), ((Z + 15) // 16) * 16)


class _ScoreHeuristicEll(StatsObject):
    _seed = 777

    @classmethod
    def _scores(cls, ell) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def run(cls, Z: int, ell, nattempt: int = 1, not_Z_bound: bool = False,
            Z_pad: int = None, draws=None) -> Tuple[np.ndarray, int, int]:
        """(z_vec [K], ZZ, rem).  ``nattempt`` is accepted for interface
        parity; the rank is deterministic, so every attempt coincides."""
        if draws is None:
            draws = TorchDraws(cls._seed, ell.mask.device)
        scores = cls._scores(ell)
        if not_Z_bound:
            # Grow the slot budget until everyone fits (gm.py:22-23): a
            # doubling host loop, never a [K, Kp] buffer.
            Z_try = _z_pad_for(ell, 2)
            while True:
                z_vec, ZZ, rem = _pack_by_scores_ell(ell, scores, Z_try,
                                                     draws, Z_try)
                if rem == 0 or Z_try >= ell.K:
                    break
                Z_try = min(2 * Z_try, ((ell.K + 15) // 16) * 16)
            return z_vec.cpu().numpy()[: ell.K], ZZ, rem
        if Z_pad is None:
            Z_pad = _z_pad_for(ell, Z)
        z_vec, ZZ, rem = _pack_by_scores_ell(ell, scores, int(Z), draws,
                                             Z_pad)
        return z_vec.cpu().numpy()[: ell.K], ZZ, rem


class MAX_GAIN_ELL(_ScoreHeuristicEll):
    @classmethod
    def _scores(cls, ell):
        return incoming_gain_scores(ell)


class MAX_ASSO_ELL(_ScoreHeuristicEll):
    @classmethod
    def _scores(cls, ell):
        return asso_degree_scores(ell)


class MAX_RAND_ELL(StatsObject):
    @classmethod
    def run(cls, Z: int, ell, nattempt: int = 1, Z_pad: int = None,
            draws=None) -> Tuple[np.ndarray, int, int]:
        """(z_vec [K], Z, rem)."""
        if draws is None:
            draws = TorchDraws(4242, ell.mask.device)
        if Z_pad is None:
            Z_pad = _z_pad_for(ell, Z)
        z_vec, rem = _pack_random_ell(ell, int(Z), draws, Z_pad)
        return z_vec.cpu().numpy()[: ell.K], Z, rem
