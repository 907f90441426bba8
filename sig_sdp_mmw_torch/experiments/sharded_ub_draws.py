"""How far the sharded cell's ``ub`` moves with the solve's random draws.

The one-process solve of ``experiments/sharded_large.py`` (cell 100,
K=30,000, nit 30, eta 0.05, Z 18, D_pad 48, 128x128 float32 block-ELL
operands, rows padded to 30,208) run with the port's draws
(``TorchDraws(seed)``) for each seed of ``--seeds``, and, with
``--jax-sketches FILE``, once more with the JAX package's own sketches of
``tools/sharded_large.py``'s solve (``PRNGKey(0)``), which
``tests/torch_jax_sketches.py`` writes where jax is installed.  ``ub``
reads only the sketches, so that run is the JAX tool's solve on the port.

Prints one JSON line per run (seed, ub, seconds) and a summary (min, max,
mean and standard deviation of the seeds' ub); writes the record to
``--out``.  Needs a CUDA device.

    python -m sig_sdp_mmw_torch.experiments.sharded_ub_draws --seeds 8 \\
        --jax-sketches jax_sketches.npy --out ub.json
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import time
from typing import Optional

import numpy as np
import torch

print = functools.partial(print, flush=True)


class JaxSketches:
    """Draws whose ``sketch(i)`` is the JAX package's iteration-i sketch,
    from an [nit, Kp, D_pad] float32 array; every other draw is
    ``TorchDraws(0)``'s (the factor's Ω does not enter ``ub``)."""

    def __init__(self, sketches: np.ndarray, device):
        from sig_sdp_mmw_torch.utils.draws import TorchDraws

        self._sketches = sketches
        self._device = device
        self._rest = TorchDraws(0, device)

    def sketch(self, i, shape, dtype):
        s = self._sketches[i]
        if tuple(s.shape) != tuple(shape):
            raise ValueError(f"sketch {i}: recorded {s.shape}, asked {shape}")
        return torch.from_numpy(np.ascontiguousarray(s)).to(self._device,
                                                             dtype)

    def __getattr__(self, role):
        return getattr(self._rest, role)


def main(seeds: int = 8, jax_sketches: Optional[str] = None,
         out: Optional[str] = None) -> dict:
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.sharded_large import layout_operands
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    dev = resolve_device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    S, Q, h = LargeEnv(100, 75e-4, seed=0).generate_state_csr()
    K, block, nit = S.shape[0], 128, 30
    nr = -(-K // (block * 2)) * block * 2          # sharded_large at graph 2
    Z = float(int(np.diff(Q.indptr).max()) + 1 + 4)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    ell = ell_slim_from_csr(S, Q, h, pad_rows_to=nr, device=dev)
    ops = layout_operands(S, Q, block, nr, "f32_ell").to(dev)

    def solve(draws):
        t0 = time.time()
        o = mmw_solve_ell(ell, Z, nit=nit, eta=0.05, D_pad=D_pad,
                          rank_pad=D_pad, draws=draws, bcsr=ops)
        cuda_sync(o.X_half)
        return float(o.ub_final), time.time() - t0

    rec = dict(gpu=gpu, K=K, rows_padded=nr, Z=Z, D_pad=D_pad, nit=nit,
               runs=[])
    for seed in range(seeds):
        ub, sec = solve(TorchDraws(seed, dev))
        rec["runs"].append(dict(draws=f"TorchDraws({seed})", ub=ub, s=sec))
        print(json.dumps(rec["runs"][-1]))
    ubs = [r["ub"] for r in rec["runs"]]
    rec["seeds_ub"] = dict(min=min(ubs), max=max(ubs),
                           mean=statistics.fmean(ubs),
                           stdev=statistics.stdev(ubs) if seeds > 1 else 0.0)
    if jax_sketches:
        ub, sec = solve(JaxSketches(np.load(jax_sketches, mmap_mode="r"),
                                    dev))
        rec["jax_sketches_ub"] = ub
        print(json.dumps(dict(draws="JAX PRNGKey(0) sketches", ub=ub, s=sec)))
    print(json.dumps({k: rec[k] for k in ("seeds_ub", "jax_sketches_ub")
                      if k in rec}))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--jax-sketches")
    ap.add_argument("--out")
    a = ap.parse_args()
    main(a.seeds, a.jax_sketches, a.out)
