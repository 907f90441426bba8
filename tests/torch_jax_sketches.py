"""Write the JAX package's MMW sketches of one solve to an .npy, for a
machine without jax to replay (``sig_sdp_mmw_torch.experiments.
sharded_ub_draws --jax-sketches``): iteration i's sketch of
``mmw_solve_ell(..., key=PRNGKey(seed))`` is
``normal(fold_in(key, i), (Kp, D_pad), float32)``, the draw
``torch_jax_parity.JaxDraws.sketch`` makes.  The defaults are
``tools/sharded_large.py``'s solve at cell 100 (Kp 30,208, D_pad 48,
nit 30, ``PRNGKey(0)``): 174 MB.  ``--threefry-partitionable 0`` draws
the stream of JAX releases before 0.5, whose default it was.

    python tests/torch_jax_sketches.py --out jax_sketches.npy
"""

import argparse
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_jax_parity import JaxDraws  # noqa: E402


def main(Kp: int = 30208, D_pad: int = 48, nit: int = 30, seed: int = 0,
         out: str = "jax_sketches.npy") -> None:
    draws = JaxDraws(jax.random.PRNGKey(seed), nit)
    arr = np.lib.format.open_memmap(out, mode="w+", dtype=np.float32,
                                    shape=(nit, Kp, D_pad))
    for i in range(nit):
        arr[i] = draws.sketch(i, (Kp, D_pad), torch.float32).numpy()
    arr.flush()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kp", type=int, default=30208)
    ap.add_argument("--d-pad", type=int, default=48)
    ap.add_argument("--nit", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threefry-partitionable", type=int, choices=(0, 1))
    ap.add_argument("--out", default="jax_sketches.npy")
    a = ap.parse_args()
    if a.threefry_partitionable is not None:
        jax.config.update("jax_threefry_partitionable",
                          bool(a.threefry_partitionable))
    main(a.kp, a.d_pad, a.nit, a.seed, a.out)
