"""Greedy scheduling heuristics of the dense state (comparison baselines).

Port of :mod:`sig_sdp_mmw_tpu.models.heuristics` (reference
``sim_src/alg/gm.py``):

* :class:`MAX_GAIN`  — slot-major greedy packing, users ranked by total
  incoming gain (``gm.py:6-66``);
* :class:`MAX_ASSO`  — same, ranked by association degree (``gm.py:69-129``);
* :class:`MAX_RAND`  — user-major greedy with a random user order and random
  slot preferences but the same feasibility checks (``gm.py:131-200``);
* ``not_Z_bound=True`` lets the packing use up to K slots, so everyone fits
  (``gm.py:22-23``).

Slot-major reference, user-major implementation.  The reference packs slot
by slot, scanning the unplaced users in score order within each slot
(``gm.py:24-58``); the JAX package runs that as Z_pad x K user steps.  With a
deterministic score order, the user-major greedy in which each user takes
the lowest feasible slot given the higher-ranked users' assignments reaches
the same assignment: when user k is checked against slot z, both see
exactly the higher-ranked users placed in z (by induction over the score
order), and both give k the first slot that admits it.  Checking only k's
gain and association neighbours among the members, as the shared
feasibility scan does, is the same test, since every member already meets
its own budget.  So the port runs K user steps of the dense rounding's scan
(:func:`sig_sdp_mmw_torch.models.rounding._greedy_assign`, slot preference =
slot index) and returns the JAX package's (z_vec, ZZ, rem).

Random draws come from a draws object by role, by default
:class:`sig_sdp_mmw_torch.utils.draws.TorchDraws` seeded as the JAX package
seeds its keys: ``score_fill`` (777) for MAX_GAIN/MAX_ASSO; ``rand_gx``,
``rand_rv`` and ``rand_fill`` (4242) for MAX_RAND.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.models.rounding import (_default_z_pad,
                                               _greedy_assign, _one_attempt)
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.stats import StatsObject


def _greedy_pack_slot_major(state: SigState, scores, Z: int, draws,
                            Z_pad: int, nattempt: int = 1):
    """The reference's slot-major packing (module docstring): users in
    decreasing score order, each into the lowest slot below Z that passes
    the interference and association checks.  (z_vec [Kp] int32, ZZ, rem);
    ZZ is the number of slots used when everyone fits (``gm.py:57-58``),
    else Z.

    ``nattempt``: the reference's per-slot retries keep the longest packing
    (``gm.py:29-53``); the rank is deterministic, so every attempt coincides
    and the first is kept."""
    if nattempt < 1:
        raise ValueError(f"nattempt={nattempt} < 1")
    Kp, mask = state.Kp, state.mask
    order = torch.argsort(-torch.where(mask, scores, -torch.inf),
                          stable=True)
    pref = torch.arange(Z_pad, dtype=torch.int32, device=mask.device
                        )[None, :, None].expand(1, Z_pad, Kp)
    slot_of, rem, assigned = _greedy_assign(state, order[None, :], pref, Z,
                                            Z_pad)
    slot_of, assigned, rem = slot_of[0], assigned[0], int(rem[0])
    ZZ = (int(torch.max(torch.where(mask, slot_of, -1))) + 1 if rem == 0
          else int(Z))
    fill = draws.score_fill(Kp, ZZ).to(slot_of.device)
    z_vec = torch.where(assigned, slot_of, fill)
    return torch.where(mask, z_vec, 0), ZZ, rem


def _greedy_user_major_random(state: SigState, Z: int, draws, Z_pad: int):
    """MAX_RAND (``gm.py:131-200``): a random factor gives a random user
    order, random slot vectors random preferences; the SDP rounding's
    feasibility scan, one attempt.  (z_vec [Kp] int32, rem)."""
    Kp, mask = state.Kp, state.mask
    dtype, device = state.S.dtype, mask.device
    gX = draws.rand_gx((Kp, 8), dtype).to(device)
    gX = torch.where(mask[:, None], gX, 0.0)
    rv = draws.rand_rv((Z_pad, 8), dtype).to(device)
    rv = rv / torch.clamp(torch.linalg.norm(rv, dim=1, keepdim=True),
                          min=1e-30)
    slot_of, rem, assigned = _one_attempt(state, gX, rv[None], Z, Z_pad)
    fill = draws.rand_fill(Kp, Z).to(device)
    z_vec = torch.where(assigned[0], slot_of[0], fill)
    return torch.where(mask, z_vec, 0), int(rem[0])


class _SlotMajorHeuristic(StatsObject):
    _seed = 777

    @classmethod
    def _scores(cls, state: SigState) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def run(cls, Z: int, state: SigState, nattempt: int = 1,
            not_Z_bound: bool = False, draws=None
            ) -> Tuple[np.ndarray, int, int]:
        """(z_vec [K], ZZ, rem)."""
        if draws is None:
            draws = TorchDraws(cls._seed, state.mask.device)
        if not_Z_bound:
            Z = state.K
        Z_pad = min(max(_default_z_pad(state), ((Z + 15) // 16) * 16),
                    state.Kp)
        if Z > Z_pad:
            Z_pad = ((Z + 15) // 16) * 16
        z_vec, ZZ, rem = _greedy_pack_slot_major(
            state, cls._scores(state), int(Z), draws, Z_pad,
            nattempt=nattempt)
        return z_vec.cpu().numpy()[: state.K], ZZ, rem


class MAX_GAIN(_SlotMajorHeuristic):
    """Rank by total incoming interference (``gm.py:18``: row sums of S^T
    with zero diagonal).  Users of one AP often have the same sum but for
    its last bits, so their rank follows the summation order, which differs
    between this package and the JAX one."""

    @classmethod
    def _scores(cls, state: SigState):
        eye = torch.eye(state.Kp, dtype=torch.bool, device=state.S.device)
        return torch.sum(torch.where(eye, 0.0, state.S).T, dim=1)


class MAX_ASSO(_SlotMajorHeuristic):
    """Rank by association degree (``gm.py:81``)."""

    @classmethod
    def _scores(cls, state: SigState):
        return torch.sum(state.Q, dim=1)


class MAX_RAND(StatsObject):
    @classmethod
    def run(cls, Z: int, state: SigState, nattempt: int = 1, draws=None
            ) -> Tuple[np.ndarray, int, int]:
        """(z_vec [K], Z, rem)."""
        if draws is None:
            draws = TorchDraws(4242, state.mask.device)
        Z_pad = max(_default_z_pad(state), ((Z + 15) // 16) * 16)
        z_vec, rem = _greedy_user_major_random(state, int(Z), draws, Z_pad)
        return z_vec.cpu().numpy()[: state.K], Z, rem
