"""Instrumentation: phase timers, in-memory metric tables, debug prints.

Port of :mod:`sig_sdp_mmw_tpu.utils.stats` (the reference's
``STATS_OBJECT`` mixin and ``sim_src/util.py`` helpers): the same metric keys
and table format (``{key: ndarray}`` with a ``(g_step, step, unix_time)``
header before the payload row; ``save_np`` writes
``<Class>.<key>.<postfix>.txt``), microsecond tic/tim timers, moving
averages and rate-limited debug prints.  ``tim()`` waits for queued CUDA
work on its ``sync`` handle (``torch.cuda.synchronize``) so a phase's time
includes the device work it launched.  ``p_true`` draws from numpy's global
stream, as the JAX package's does.
"""

from __future__ import annotations

import os
import pprint
import time
from typing import Any, Dict, List, Optional

import numpy as np

from sig_sdp_mmw_torch.utils.tensors import cuda_sync

LOGGED_NP_DATA_HEADER_SIZE = 3


def get_current_time_str() -> str:
    from datetime import datetime

    return datetime.now().strftime("%Y-%B-%d-%H-%M-%S")


class StatsObject:
    """Mixin: per-instance metric tables + µs timers + rate-limited prints."""

    DISABLE_ALL_DEBUG = False
    DEBUG_STEP = 100
    DEBUG = False
    PRINT_DIM = 5
    MOVING_AVERAGE_TIME_WINDOW = 100

    # --- lazy per-instance state -------------------------------------------------
    def _stats_init(self) -> None:
        if not hasattr(self, "_np_log"):
            self._np_log: Dict[str, List[np.ndarray]] = {}
            self._np_log_width: Dict[str, int] = {}
            self._timers: Dict[int, float] = {}
            self._ntimer = 0
            self._mavg: Dict[str, float] = {}
            self._mavg_n: Dict[str, float] = {}
            self.N_STEP = 0
            self.LOGGED_CLASS_NAME: Optional[str] = None

    # --- metric tables ------------------------------------------------------------
    def _add_np_log(self, key: str, step: int, float_row_data, g_step: int = 0) -> None:
        self._stats_init()
        row = np.atleast_1d(np.squeeze(np.asarray(float_row_data,
                                                  dtype=np.float64)))
        if row.ndim != 1:
            raise ValueError(f"metric row for {key!r} must be 1-D")
        width = self._np_log_width.setdefault(
            key, row.size + LOGGED_NP_DATA_HEADER_SIZE)
        if row.size + LOGGED_NP_DATA_HEADER_SIZE != width:
            raise ValueError(f"metric row for {key!r} changed width")
        self._np_log.setdefault(key, []).append(
            np.hstack((np.array([g_step, step, time.time()]), row)))

    @property
    def LOGGED_NP_DATA(self) -> Dict[str, np.ndarray]:
        """Materialized metric tables (reference-compatible view)."""
        self._stats_init()
        return {k: np.vstack(v) for k, v in self._np_log.items()}

    def save_np(self, path: str, postfix: str) -> None:
        os.makedirs(path, exist_ok=True)
        name = self.LOGGED_CLASS_NAME or self.__class__.__name__
        for key, tab in self.LOGGED_NP_DATA.items():
            np.savetxt(os.path.join(path, f"{name}.{key}.{postfix}.txt"), tab,
                       delimiter=",")

    # --- timers -------------------------------------------------------------------
    def _get_tic(self) -> int:
        self._stats_init()
        self._ntimer += 1
        self._timers[self._ntimer] = time.time()
        return self._ntimer

    def _get_tim(self, tic_id: int, sync: Any = None) -> float:
        """Elapsed µs since ``tic_id``; waits for ``sync`` (a tensor or a
        tensor container) first so queued CUDA work is included."""
        cuda_sync(sync)
        t0 = self._timers.pop(tic_id, None)
        if t0 is None:
            raise KeyError("no timer is found.")
        return (time.time() - t0) * 1e6

    # --- moving averages ------------------------------------------------------
    def _moving_average(self, key: str, new_value: float) -> float:
        self._stats_init()
        if key not in self._mavg:
            self._mavg[key] = 0.0
            self._mavg_n[key] = 0.0
        step = min(self._mavg_n[key] + 1, self.MOVING_AVERAGE_TIME_WINDOW)
        self._mavg[key] = self._mavg[key] * (1.0 - 1.0 / step) + new_value / step
        self._mavg_n[key] += 1
        return self._mavg[key]

    # --- debug prints -----------------------------------------------------------
    def status(self) -> None:
        if self.DEBUG:
            pprint.pprint(vars(self))

    def _print(self, *args, **kwargs) -> None:
        self._stats_init()
        if self.DEBUG and not StatsObject.DISABLE_ALL_DEBUG and (
            self.N_STEP % self.DEBUG_STEP in (0, 1, 2)
        ):
            print(("%6d\t" % self.N_STEP) + " ".join(map(str, args)), **kwargs)

    def _printalltime(self, *args, **kwargs) -> None:
        self._stats_init()
        print(("%6d\t" % self.N_STEP) + ("%10s\t" % self.__class__.__name__)
              + " ".join(map(str, args)), **kwargs)

    def _debug(self, enable: bool, debug_step: int = 100) -> None:
        self.DEBUG = enable
        self.DEBUG_STEP = debug_step


# Reference-compatible alias (``from sim_src.util import STATS_OBJECT``).
STATS_OBJECT = StatsObject


# ---------------------------------------------------------------------------
# Small reference-parity helpers (sim_src/util.py:12-19, 274-293)
# ---------------------------------------------------------------------------

def p_true(probability_of_true: float) -> bool:
    return bool(np.random.random() < probability_of_true)


def db_to_ratio(a):
    return 10.0 ** (np.asarray(a) / 10.0)


def ratio_to_db(a):
    return 10.0 * np.log10(np.asarray(a))


DbToRatio = db_to_ratio
RatioToDb = ratio_to_db


def plot_a_array(arr, mavg_n: int = 20, name: str = "", script_file=None,
                 postfix: str = "", idx=None, show: bool = False,
                 save_path=None):
    """Moving-average curve plot (``sim_src/util.py:274-293``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(16, 6), dpi=80)
    data = np.convolve(np.asarray(arr), np.ones(mavg_n) / mavg_n, mode="valid")
    if idx is not None:
        plt.plot(np.asarray(idx)[: data.size], data)
    else:
        plt.plot(np.arange(1, data.size + 1), data)
    if show:
        plt.show()
    if save_path:
        parts = [name, postfix, get_current_time_str()]
        if script_file:
            parts.insert(0, os.path.splitext(os.path.basename(script_file))[0])
        fig_dir = os.path.join(save_path, "saved_figures")
        os.makedirs(fig_dir, exist_ok=True)
        fig.savefig(os.path.join(fig_dir, "-".join(p for p in parts if p)))
    plt.close(fig)
    return data
