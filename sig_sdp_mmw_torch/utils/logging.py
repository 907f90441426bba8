"""CSV run logs and the timestamped log-directory helper.

A copy of :mod:`sig_sdp_mmw_tpu.utils.logging` (the reference's
``CSV_WRITER_OBJECT`` and ``GET_LOG_PATH_FOR_SIM_SCRIPT``): one CSV file per
metric name inside a per-run directory named ``<script>-<timestamp>-ail``,
so the reference's plot scripts' data-directory conventions carry over.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, Optional

from sig_sdp_mmw_torch.utils.stats import get_current_time_str


class CsvWriter:
    """``append=True`` opens each metric file for appending, so a sweep that
    resumes through :class:`~sig_sdp_mmw_torch.utils.checkpoint.SweepCheckpoint`
    keeps the rows of its earlier runs (the JAX writer truncates them)."""

    def __init__(self, path: Optional[str] = None, append: bool = False):
        self.path = path
        self.mode = "a" if append else "w"
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)
        self.files: Dict[str, object] = {}
        self.writers: Dict[str, csv.writer] = {}

    def _writer(self, data_name: str):
        if data_name not in self.files:
            f = open(os.path.join(self.path, data_name), self.mode, newline="")
            self.files[data_name] = f
            self.writers[data_name] = csv.writer(f)
        return self.writers[data_name], self.files[data_name]

    def log_one_scalar(self, data_name: str, iteration: int, value,
                       g_iteration: int = 0):
        if self.path is None:
            return
        w, f = self._writer(data_name)
        w.writerow([g_iteration, iteration, value])
        f.flush()

    def log_mul_scalar(self, data_name: str, iteration: int, values: Iterable,
                       g_iteration: int = 0):
        if self.path is None:
            return
        w, f = self._writer(data_name)
        w.writerow([g_iteration, iteration] + [v for v in values])
        f.flush()

    def close(self):
        for f in self.files.values():
            f.close()
        self.files.clear()
        self.writers.clear()


def get_log_path_for_sim_script(sim_script_path: str) -> str:
    base = os.path.splitext(os.path.basename(sim_script_path))[0]
    out_all = os.path.join(os.path.dirname(os.path.realpath(sim_script_path)),
                           base)
    os.makedirs(out_all, exist_ok=True)
    return os.path.join(out_all, f"{base}-{get_current_time_str()}-ail")


def get_file_name_for_sim_script(file: str) -> str:
    return os.path.splitext(os.path.basename(file))[0]


# Reference-compatible aliases.
CSV_WRITER_OBJECT = CsvWriter
GET_LOG_PATH_FOR_SIM_SCRIPT = get_log_path_for_sim_script
GET_FILE_NAME_FOR_SIM_SCRIPT = get_file_name_for_sim_script
