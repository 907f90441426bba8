"""Solver base class: shared knobs and the randomized-rounding entry point.

Port of :mod:`sig_sdp_mmw_tpu.models.base` (reference ``sdp_solver`` base):
``nit`` / ``rank_radio`` / ``alpha`` knobs and a ``rounding`` method whose
``nattempt`` attempts run together on the state's device
(:mod:`sig_sdp_mmw_torch.models.rounding`).  Each call draws from its own
stream of seed 1234 (the JAX package folds ``PRNGKey(1234)`` per call).
"""

from __future__ import annotations

from sig_sdp_mmw_torch.utils.draws import TorchDraws

ROUNDING_SEED = 1234


class SDPSolverBase:
    def __init__(self, nit: int = 100, rank_radio: int = 2,
                 alpha: float = 1.0):
        self.nit = nit
        self.rank_radio = rank_radio
        self.alpha = alpha  # objective scaling knob; unused by the reference
        self._round_calls = 0

    def run_with_state(self, bs_iteration: int, Z: int, state):
        raise NotImplementedError

    def rounding(self, Z: int, gX, state, nattempt: int = 10):
        from sig_sdp_mmw_torch.models.rounding import rounding

        self._round_calls += 1
        draws = TorchDraws(ROUNDING_SEED, state.mask.device,
                           stream=self._round_calls)
        return rounding(Z, gX, state, draws, nattempt=nattempt)
