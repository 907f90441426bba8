"""Mobility environment and the closed-loop online controller.

Port of :mod:`sig_sdp_mmw_tpu.env.mob` (reference ``sim_src/env/
mob_env.py``):

* :class:`MobileEnv` — period-wise user mobility stepping;
* :class:`Controller` — the "solve the next schedule while the current one
  runs" online loop that charges the solver's own wall-clock latency in
  slots.
"""

from __future__ import annotations

import math

import numpy as np

from sig_sdp_mmw_torch.env.env import WirelessEnv
from sig_sdp_mmw_torch.utils.stats import StatsObject


class MobileEnv(WirelessEnv):
    def step_a_period(self, Z: int, mob_spd_meter_s: float) -> None:
        self.rand_user_mobility(mob_spd_meter_s, self.get_period_time_us(Z))

    def get_n_period(self, Z: int, time_us: float) -> int:
        return math.ceil(time_us / (Z * self.params.slot_time * 1e6))

    def get_period_time_us(self, Z: int) -> float:
        return Z * self.params.slot_time * 1e6

    def step_time(self, time_us: float, mob_spd_meter_s: float,
                  resolution_us: float = 100000.0) -> None:
        self.rand_user_mobility(mob_spd_meter_s, time_us,
                                resolution_us=resolution_us)


class Controller(StatsObject):
    """Online scheduling loop: evaluates the *current* schedule while the
    solver computes the *next* one; users move for the duration of the
    solve.  ``alg.run(state)`` returns (z_vec, Z, remainder)."""

    def __init__(self):
        self.env: MobileEnv = None
        self.alg = None

    def _timed_solve(self):
        """Solve on a fresh snapshot of the (moving) network; return the
        schedule and the solver's own wall-clock latency in µs."""
        tic = self._get_tic()
        schedule = self.alg.run(self.env.generate_S_Q_hmax())
        return schedule, self._get_tim(tic)

    def run(self, total_time_s: float, mob_spd_meter_s: float):
        deadline_us = total_time_s * 1e6
        clock_us = 0.0
        solve_latency_us: list = []
        pkts_sent = 0
        pkts_lost = 0

        # Warm-up solve: no schedule exists yet, so the network just drifts
        # for as many periods as the solve took (no packets are charged).
        (active_z, active_Z, _), latency_us = self._timed_solve()
        for _ in range(self.env.get_n_period(active_Z, latency_us)):
            self.env.step_a_period(active_Z, mob_spd_meter_s)

        while True:
            # The next solve runs while the network serves traffic under
            # the (increasingly stale) active schedule.
            (next_z, next_Z, _), latency_us = self._timed_solve()
            solve_latency_us.append(latency_us)

            # The period length is set by the ACTIVE schedule's Z.
            for _ in range(self.env.get_n_period(active_Z, latency_us)):
                pckl = self.env.evaluate_pckl(active_z, active_Z)
                pkts_lost += int(np.sum(pckl))
                pkts_sent += self.env.n_sta
                self.env.step_a_period(active_Z, mob_spd_meter_s)
                clock_us += self.env.get_period_time_us(active_Z)

            if clock_us > deadline_us:
                break
            active_z, active_Z = next_z, next_Z

        return pkts_lost, pkts_sent, clock_us, solve_latency_us
