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


def placed_users(geometry, seed: int) -> dict:
    """``WirelessEnv`` keywords that place seed ``seed``'s users from a
    geometry npz's arrays (``sta_locs``, ``sta_dirs`` [seeds, K, 2], as
    ``tests/torch_jax_geometry.py`` writes them); none without one."""
    if geometry is None:
        return {}
    return dict(sta_locs=geometry["sta_locs"][seed],
                sta_dirs=geometry["sta_dirs"][seed])


def card_info(device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` prints them, and
    torch's device name; ``{"name": "cpu"}`` on the CPU.  Each study writes
    it into its JSON beside its times."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.splitlines()[device.index or 0]}


def launch_snapshot() -> dict:
    """The launch counts of kernels #1 (``bsr_spmm_flat``) and #3
    (``bcsr_spmm``) so far, by the route each launch took (the wrappers'
    ``route_launches``), and those of the Lanczos steps' kernels
    (``lanczos_step``, route ``"kernel"``: ``lanczos_tridiag.launches``);
    :func:`launches_since` takes the difference."""
    from sig_sdp_mmw_torch.ops import bcsr as tb
    from sig_sdp_mmw_torch.ops.expm import lanczos_tridiag

    return {"bsr_spmm_flat": dict(tb.bsr_spmm_flat.route_launches),
            "bcsr_spmm": dict(tb.bcsr_spmm.route_launches),
            "lanczos_step": {"kernel": lanczos_tridiag.launches}}


def launches_since(snap: dict) -> dict:
    """Kernel launches since ``snap``, by kernel and by the route
    (:func:`sig_sdp_mmw_torch.ops.bcsr.spmm_route`) each launch took, as
    the wrappers counted them; a kernel or route that did not launch is left
    out (on the CPU the wrappers run their plain versions and count
    nothing)."""
    out = {}
    for name, now in launch_snapshot().items():
        by_route = {r: n - snap[name].get(r, 0) for r, n in now.items()
                    if n > snap[name].get(r, 0)}
        if by_route:
            out[name] = by_route
    return out
