"""Scenario constants of the wireless environment.

Port of ``EnvParams`` from :mod:`sig_sdp_mmw_tpu.env.env`; the dense
``WirelessEnv`` belongs to the dense slice and is not ported yet.
"""

from __future__ import annotations

import dataclasses

from sig_sdp_mmw_torch.env import phy


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Scenario constants (reference ctor args)."""

    cell_edge: float = 20.0
    cell_size: int = 20
    sta_density_per_1m2: float = 5e-3
    fre_Hz: float = 4e9
    txp_dbm_hi: float = 5.0
    txp_offset: float = 2.0
    min_s_n_ratio: float = 0.1
    packet_bit: float = 800.0
    bandwidth: float = 5e6
    slot_time: float = 1.25e-4
    max_err: float = 1e-5

    @property
    def grid_edge(self) -> float:
        return self.cell_edge * self.cell_size

    @property
    def n_ap(self) -> int:
        return int(self.cell_size ** 2)

    @property
    def n_sta(self) -> int:
        return int(self.cell_size ** 2
                   * (self.sta_density_per_1m2 * self.cell_edge ** 2))

    @property
    def min_sinr(self) -> float:
        return phy.min_sinr_dec(self.packet_bit, self.bandwidth,
                                self.slot_time, self.max_err)

    @property
    def min_sinr_db(self) -> float:
        return phy.bisection_min_sinr_db(self.packet_bit, self.bandwidth,
                                         self.slot_time, self.max_err)
