"""Shared experiment-harness machinery.

Port of :mod:`sig_sdp_mmw_tpu.experiments.common`: the conventions every
reference sim script shares — a timestamped ``<script>-<time>-ail`` output
directory, one CSV file per metric name, metric names like
``mmw-<cell>-<rho*1e4>``, nested cell × seed sweeps — with ``--smoke`` (a
tiny sweep, used by tests) and ``--device`` (default ``cuda``; it raises
without a card).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from sig_sdp_mmw_torch.utils.tensors import resolve_device


def experiment_args(description: str, **extra_defaults):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--repeat", type=int,
                   default=extra_defaults.pop("repeat", 100))
    p.add_argument("--rho", type=float, default=extra_defaults.pop("rho", 75e-4))
    p.add_argument("--cells", type=int, nargs="*",
                   default=extra_defaults.pop("cells", list(range(5, 16))))
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="tiny sweep for CI: 1 seed, small cells")
    p.add_argument("--out", type=str, default=None)
    for k, v in extra_defaults.items():
        p.add_argument(f"--{k}", type=type(v), default=v)
    return p


def setup(args):
    """Resolve the device (TF32 off; raises without a requested card) and
    shrink the sweep in smoke mode."""
    args.device = resolve_device(args.device)
    if args.smoke:
        args.repeat = 1
        args.cells = [c for c in args.cells if c <= 5] or [5]
    np.set_printoptions(threshold=10, linewidth=1000)


def make_log(script_file: str, out: Optional[str] = None,
             append: bool = False):
    from sig_sdp_mmw_torch.utils.logging import (CsvWriter,
                                                 get_log_path_for_sim_script)

    path = out or get_log_path_for_sim_script(script_file)
    print(path)
    return CsvWriter(path=path, append=append), path
