"""Wireless scenario generator and evaluator of the dense path, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.env.env` (reference ``sim_src/env/env.py``):
pure functions on tensors of a static geometry, and the stateful
:class:`WirelessEnv` with the reference's API (``generate_S_Q_hmax``,
``evaluate_sinr``, ``evaluate_bler``, ``evaluate_pckl``,
``rand_user_mobility``).

* the evaluator's per-slot and per-AP loops are dense masked computations:
  the same-slot interference is a masked row sum and the per-(AP, slot)
  "strongest user wins" rule a pairwise dominance test;
* user positions and directions are drawn from ``torch.Generator``s seeded
  from ``seed`` (:class:`sig_sdp_mmw_torch.utils.draws.TorchDraws`; separate
  streams for location, direction, mobility and packet loss), or injected
  (``sta_locs=``, ``sta_dirs=``) — the same seed gives other users than the
  JAX package, with the same K: distributional parity;
* the geometry and evaluation run in float64 on the env's device; the
  generator emits the padded :class:`SigState` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.core.problem import SigState, _round_up, state_from_arrays
from sig_sdp_mmw_torch.env import phy
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.tensors import resolve_device


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


# ---------------------------------------------------------------------------
# Geometry and channel state
# ---------------------------------------------------------------------------

def ap_grid(p: EnvParams, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """AP positions on a cell_size x cell_size grid; AP a = i*cell_size + j
    sits at (x[j], y[i]) (the reference's ``meshgrid`` + ravel order)."""
    offset = p.cell_edge / 2.0
    x = np.linspace(offset, p.grid_edge - offset, p.cell_size)
    xx, yy = np.meshgrid(x, x)
    return torch.tensor(np.stack([xx.ravel(), yy.ravel()], axis=1),
                        dtype=dtype, device=device)


def sample_sta_locs(generator: torch.Generator, p: EnvParams,
                    device="cpu", dtype=torch.float32) -> torch.Tensor:
    """[n_sta, 2] user positions, uniform on the grid (the counterpart of the
    JAX function, which takes a key; ``generator`` lies on ``device``)."""
    u = torch.rand((p.n_sta, 2), generator=generator, dtype=dtype,
                   device=device)
    return u * p.grid_edge


def sample_sta_dirs(generator: torch.Generator, n: int, device="cpu",
                    dtype=torch.float32) -> torch.Tensor:
    """[n, 2] unit heading vectors from a Gaussian draw."""
    d = torch.randn((n, 2), generator=generator, dtype=dtype, device=device)
    return d / torch.linalg.norm(d, dim=1, keepdim=True)


def rxpr_unthresholded(sta_locs: torch.Tensor, aps: torch.Tensor,
                       p: EnvParams) -> torch.Tensor:
    """[K, A] received-power-to-noise ratios under per-user power control:
    each user aims ``min_sinr + txp_offset`` (dB) at its strongest AP."""
    dis = torch.linalg.norm(sta_locs[:, None, :] - aps[None, :, :], dim=-1)
    loss = phy.fre_dis_to_loss_db(p.fre_Hz, dis)                 # [K, A]
    smax = torch.max(-loss, dim=1).values                        # [K]
    noise = phy.noise_dbm(p.bandwidth)
    txp = (p.min_sinr_db - (smax - noise)
           + 10.0 * math.log10(p.txp_offset))[:, None]           # [K, 1]
    return 10.0 ** ((txp - loss - noise) / 10.0)


def threshold_rxpr(rxpr: torch.Tensor, p: EnvParams) -> torch.Tensor:
    """Sparsify: ratios below ``min_s_n_ratio`` are zeroed."""
    return torch.where(rxpr < p.min_s_n_ratio, 0.0, rxpr)


def state_arrays_from_rxpr(rxpr: torch.Tensor, p: EnvParams):
    """(S, Q, h_max, asso) from a [K, A] rxpr matrix: S[k, j] = rxpr[k,
    asso[j]]; Q[i, j] = 1 iff asso_i == asso_j (i != j); h_max =
    diag(S)/min_sinr - 1."""
    K = rxpr.shape[0]
    asso = torch.argmax(rxpr, dim=1)                             # first max
    S = rxpr[:, asso]
    eye = torch.eye(K, dtype=rxpr.dtype, device=rxpr.device)
    Q = (asso[:, None] == asso[None, :]).to(rxpr.dtype) * (1.0 - eye)
    h_max = torch.diagonal(S) / p.min_sinr - 1.0
    return S, Q, h_max, asso


# ---------------------------------------------------------------------------
# Evaluation (unthresholded channel, winner-takes-AP rule)
# ---------------------------------------------------------------------------

def evaluate_sinr_from_rxpr(rxpr_real: torch.Tensor, z: torch.Tensor,
                            p: EnvParams) -> torch.Tensor:
    """Per-user SINR of assignment ``z``:

    1. same-slot interference: for user k, the sum of the other same-slot
       users' gains at k's AP (rows of S^T, zero diagonal);
    2. per-(AP, slot) winner rule: within each association + slot group only
       the strongest user keeps its SINR, the rest drop to 1e-3 (the first
       index wins ties, as ``np.ma.argmax``).
    """
    S, _, _, asso = state_arrays_from_rxpr(rxpr_real, p)
    K = S.shape[0]
    eye = torch.eye(K, dtype=torch.bool, device=S.device)
    same_slot = (z[:, None] == z[None, :]) & ~eye
    interference = torch.sum(torch.where(same_slot, S.T, 0.0), dim=1)
    sinr = torch.diagonal(S) / (interference + 1.0)

    same_group = same_slot & (asso[:, None] == asso[None, :])
    idx = torch.arange(K, device=S.device)
    beaten = (sinr[None, :] > sinr[:, None]) | (
        (sinr[None, :] == sinr[:, None]) & (idx[None, :] < idx[:, None]))
    loses = torch.any(same_group & beaten, dim=1)
    return torch.where(loses, 1e-3, sinr)


def evaluate_bler_from_sinr(sinr: torch.Tensor, p: EnvParams) -> torch.Tensor:
    return phy.polyanskiy_model(sinr, p.packet_bit, p.bandwidth, p.slot_time)


# ---------------------------------------------------------------------------
# Mobility
# ---------------------------------------------------------------------------

def mobility_substep(rnd: torch.Tensor, sta_locs: torch.Tensor,
                     sta_dirs: torch.Tensor, speed_m_s: float,
                     resolution_us: float, grid_edge: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One mobility step of every user: advance along the unit direction;
    users that would leave the grid stay put and take the direction of
    their row of ``rnd`` (a Gaussian [n, 2] draw, normalized here)."""
    cand = sta_locs + sta_dirs * speed_m_s * resolution_us / 1e6
    ok = torch.all((cand >= 0.0) & (cand <= grid_edge), dim=1, keepdim=True)
    new_locs = torch.where(ok, cand, sta_locs)
    rnd = rnd / torch.linalg.norm(rnd, dim=1, keepdim=True)
    return new_locs, torch.where(ok, sta_dirs, rnd)


# ---------------------------------------------------------------------------
# Stateful wrapper (reference API)
# ---------------------------------------------------------------------------

class WirelessEnv:
    """Reference-compatible environment object (``sim_src/env/env.py:5``)
    on ``device`` (default ``cuda``; it raises without a card, pass
    ``device="cpu"`` for the CPU).  ``dtype`` is the state's."""

    def __init__(self, cell_edge: float = 20.0, cell_size: int = 20,
                 sta_density_per_1m2: float = 5e-3, fre_Hz: float = 4e9,
                 txp_dbm_hi: float = 5.0, txp_offset: float = 2.0,
                 min_s_n_ratio: float = 0.1, packet_bit: float = 800.0,
                 bandwidth: float = 5e6, slot_time: float = 1.25e-4,
                 max_err: float = 1e-5, seed: int = 1,
                 pad_to: Optional[int] = None, device="cuda",
                 dtype=torch.float32, sta_locs=None, sta_dirs=None):
        self.params = EnvParams(
            cell_edge=cell_edge, cell_size=cell_size,
            sta_density_per_1m2=sta_density_per_1m2, fre_Hz=fre_Hz,
            txp_dbm_hi=txp_dbm_hi, txp_offset=txp_offset,
            min_s_n_ratio=min_s_n_ratio, packet_bit=packet_bit,
            bandwidth=bandwidth, slot_time=slot_time, max_err=max_err)
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pad_to = pad_to
        self.draws = TorchDraws(seed, self.device)
        self._mob_counter = 0
        geo = torch.float64

        def placed(a):
            return torch.as_tensor(np.asarray(a), dtype=geo,
                                   device=self.device)

        n = self.params.n_sta
        self.ap_locs = ap_grid(self.params, geo, self.device)
        self.sta_locs = (placed(sta_locs) if sta_locs is not None else
                         self.draws.locations((n, 2), geo)
                         * self.params.grid_edge)
        if sta_dirs is not None:
            self.sta_dirs = placed(sta_dirs)
        else:
            d = self.draws.directions((n, 2), geo)
            self.sta_dirs = d / torch.linalg.norm(d, dim=1, keepdim=True)

    # -- reference-compatible properties ------------------------------------
    @property
    def n_sta(self) -> int:
        return self.params.n_sta

    @property
    def n_ap(self) -> int:
        return self.params.n_ap

    @property
    def min_sinr(self) -> float:
        return self.params.min_sinr

    @property
    def slot_time(self) -> float:
        return self.params.slot_time

    # -- state generation ----------------------------------------------------
    def rxpr(self, real: bool = False) -> torch.Tensor:
        r = rxpr_unthresholded(self.sta_locs, self.ap_locs, self.params)
        return r if real else threshold_rxpr(r, self.params)

    def generate_state(self, real: bool = False) -> SigState:
        S, Q, h_max, _ = state_arrays_from_rxpr(self.rxpr(real), self.params)
        pad = (self.pad_to if self.pad_to is not None
               else _round_up(self.n_sta, 8))
        return state_from_arrays(S, Q, h_max, pad_to=pad, dtype=self.dtype,
                                 device=self.device)

    # Reference name (``env.py:168``).
    def generate_S_Q_hmax(self, real: bool = False) -> SigState:
        return self.generate_state(real=real)

    # -- evaluation -----------------------------------------------------------
    def _sinr(self, z) -> torch.Tensor:
        z = torch.as_tensor(np.asarray(z)[: self.n_sta].astype(np.int64),
                            device=self.device)
        return evaluate_sinr_from_rxpr(self.rxpr(real=True), z, self.params)

    def evaluate_sinr(self, z, Z=None) -> np.ndarray:
        return self._sinr(z).cpu().numpy()

    def evaluate_bler(self, z, Z=None) -> np.ndarray:
        return evaluate_bler_from_sinr(self._sinr(z),
                                       self.params).cpu().numpy()

    def evaluate_pckl(self, z, Z=None) -> np.ndarray:
        bler = evaluate_bler_from_sinr(self._sinr(z), self.params)
        self._mob_counter += 1
        return self.draws.packet_loss(self._mob_counter, bler).cpu().numpy()

    # -- mobility -------------------------------------------------------------
    def rand_user_mobility(self, mobility_in_meter_s: float = 0.0,
                           t_us: float = 0, resolution_us: float = 1.0
                           ) -> None:
        if mobility_in_meter_s == 0.0 or t_us == 0.0:
            return
        locs, dirs = self.sta_locs, self.sta_dirs
        for _ in range(math.ceil(t_us / resolution_us)):
            self._mob_counter += 1
            rnd = self.draws.mobility(self._mob_counter, dirs.shape,
                                      dirs.dtype)
            locs, dirs = mobility_substep(
                rnd, locs, dirs, float(mobility_in_meter_s),
                float(resolution_us), float(self.params.grid_edge))
        self.sta_locs, self.sta_dirs = locs, dirs
