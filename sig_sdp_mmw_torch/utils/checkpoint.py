"""Sweep-level checkpoint/resume.

A copy of :mod:`sig_sdp_mmw_tpu.utils.checkpoint` (pure Python).  The
reference has no checkpointing: long sweeps append CSV rows and a crash
restarts the sweep.  Solver state is tiny, so the useful granularity is
per-(metric, seed) work items: a JSONL ledger in the output dir records
completed items, and a resumed run skips them.  Experiment scripts opt in
via::

    ck = SweepCheckpoint(out_dir)
    for seed in seeds:
        if ck.done("mmw-10-75", seed):
            continue
        ...run...
        ck.mark("mmw-10-75", seed)
"""

from __future__ import annotations

import json
import os
from typing import Set, Tuple


class SweepCheckpoint:
    def __init__(self, out_dir: str, name: str = "checkpoint.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, name)
        self._done: Set[Tuple[str, int]] = set()
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        self._done.add((rec["item"], int(rec["seed"])))
                    except (json.JSONDecodeError, KeyError):
                        continue
        self._f = open(self.path, "a")

    def done(self, item: str, seed: int) -> bool:
        return (item, int(seed)) in self._done

    def mark(self, item: str, seed: int) -> None:
        self._done.add((item, int(seed)))
        self._f.write(json.dumps({"item": item, "seed": int(seed)}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
