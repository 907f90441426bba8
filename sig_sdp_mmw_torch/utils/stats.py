"""Instrumentation: phase timers and in-memory metric tables.

Port of the ``StatsObject`` mixin of :mod:`sig_sdp_mmw_tpu.utils.stats`
(the reference's ``STATS_OBJECT``), cut to what the port's solver and search
use: the same metric keys and table format (``{key: ndarray}`` with a
``(g_step, step, unix_time)`` header before the payload row) and microsecond
tic/tim timers.  ``tim()`` waits for queued CUDA work on its ``sync`` handle
(``torch.cuda.synchronize``) so a phase's time includes the device work it
launched.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from sig_sdp_mmw_torch.utils.tensors import cuda_sync

LOGGED_NP_DATA_HEADER_SIZE = 3


def get_current_time_str() -> str:
    from datetime import datetime

    return datetime.now().strftime("%Y-%B-%d-%H-%M-%S")


class StatsObject:
    """Mixin: per-instance metric tables + µs timers."""

    # --- lazy per-instance state -------------------------------------------------
    def _stats_init(self) -> None:
        if not hasattr(self, "_np_log"):
            self._np_log: Dict[str, List[np.ndarray]] = {}
            self._np_log_width: Dict[str, int] = {}
            self._timers: Dict[int, float] = {}
            self._ntimer = 0
            self.N_STEP = 0

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

    def _printalltime(self, *args, **kwargs) -> None:
        self._stats_init()
        print(("%6d\t" % self.N_STEP) + ("%10s\t" % self.__class__.__name__)
              + " ".join(map(str, args)), **kwargs)
