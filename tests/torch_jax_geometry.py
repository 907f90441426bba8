"""The JAX package's users, written for the port.

The port draws its users from torch generators, so its seed s places other
users than the JAX package's seed s.  This helper records the JAX
``WirelessEnv``'s ``sta_locs`` and ``sta_dirs`` for a range of seeds, so the
port can run a study on the same users (its ``--geometry`` option) without
importing JAX:

    PYTHONPATH=. python tests/torch_jax_geometry.py

writes ``tests/fixtures/oracle_z_cell10_geometry.npz``: the users of
``WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=s)`` for s = 0
to 99 (the matched-Z oracle study's ensemble, ``ORACLE_Z.md``), as float32
arrays of shape [100, 300, 2].  Only the tests import this module.
"""

import argparse
import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "oracle_z_cell10_geometry.npz")
CELL, RHO, SEEDS = 10, 0.0075, 100


def jax_geometry(seed: int, cell: int = CELL, rho: float = RHO):
    """(sta_locs, sta_dirs) of the JAX ``WirelessEnv`` at ``seed``, as
    float32 numpy arrays: the draws of a process without x64 (the studies'
    default), also where the caller enabled x64, as the tests do (x64 draws
    other uniforms)."""
    import jax

    from sig_sdp_mmw_tpu.env import WirelessEnv

    with jax.enable_x64(False):
        e = WirelessEnv(cell_size=cell, sta_density_per_1m2=rho, seed=seed)
        return (np.asarray(e.sta_locs, np.float32),
                np.asarray(e.sta_dirs, np.float32))


def write_fixture(path: str = FIXTURE, seeds: int = SEEDS, cell: int = CELL,
                  rho: float = RHO) -> str:
    locs, dirs = zip(*(jax_geometry(s, cell, rho) for s in range(seeds)))
    np.savez_compressed(path, sta_locs=np.stack(locs), sta_dirs=np.stack(dirs),
                        cell=np.int64(cell), rho=np.float64(rho))
    return path


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=FIXTURE)
    p.add_argument("--seeds", type=int, default=SEEDS)
    a = p.parse_args()
    print(write_fixture(a.out, a.seeds))
