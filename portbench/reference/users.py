"""Users of the dense deployment, drawn from the benchmark's seed.

:func:`draw_users` gives request ``index``'s users: positions uniform on
the grid and unit headings, from a NumPy generator seeded by
``(seed, index)``, so every request of every run has its own network and
the same seed gives the same networks.
"""

from __future__ import annotations

import numpy as np


def draw_users(n: int, grid_edge: float, seed: int, index: int):
    """(locs [n, 2], dirs [n, 2]) float64 of request ``index``."""
    rng = np.random.default_rng([int(seed), int(index)])
    locs = rng.uniform(0.0, grid_edge, size=(n, 2))
    d = rng.standard_normal((n, 2))
    return locs, d / np.linalg.norm(d, axis=1, keepdims=True)

