"""Random draws of the solver and the rounding, by role.

The JAX package derives every draw from one key (``fold_in``/``split``) on a
fixed schedule; torch cannot reproduce ``jax.random`` streams.  The port
asks a draws object for each draw by its role instead, so a test can inject
the JAX draws (made with ``jax.random`` on the JAX schedule) and compare
trajectories, while a run uses :class:`TorchDraws`:

* ``sketch(i, shape, dtype)``   — MMW iteration i's Gaussian sketch;
* ``omega(shape, dtype)``       — the final factorization's test matrix;
* ``gap(i, shape, dtype)``      — the start vector of iteration i's gap
  Lanczos (``log_gap``);
* ``rounding_rv(attempt, Z, D, dtype)`` — a rounding attempt's [Z, D]
  Gaussian slot vectors;
* ``fill(attempt, K, Z)``       — the random slot of every user left
  unassigned by that attempt (numpy int32 [K]).

The dense path (``models/rounding.py``, ``env/env.py``) adds:

* ``dense_rounding_rv(attempt, Z_pad, D, dtype)`` — a dense rounding
  attempt's [Z_pad, D] Gaussian slot vectors (all Z_pad slots drawn);
* ``dense_fill(Kp, Z)``         — the dense rounding's one fallback draw: a
  random slot in [0, max(Z, 1)) for each of the Kp users (int32 tensor on
  the draws' device);
* ``locations(shape, dtype)``   — uniform [0, 1) user positions (scaled to
  the grid by the env);
* ``directions(shape, dtype)``  — the users' initial Gaussian directions;
* ``mobility(step, shape, dtype)`` — mobility substep ``step``'s Gaussian
  direction redraws;
* ``packet_loss(step, bler)``   — packet-loss evaluation ``step``'s
  Bernoulli(bler) draws (int32, on bler's device).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """splitmix64 over the words: one independent 63-bit seed per draw."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h >> 1


_SKETCH, _OMEGA, _GAP, _ROUND, _FILL = range(5)
_DENSE_RV, _DENSE_FILL, _LOC, _DIR, _MOB, _PCKL = range(5, 11)


class TorchDraws:
    """Draws from ``torch.Generator``s seeded by (seed, stream, role,
    index), so each draw is reproducible on its own, like a folded-in JAX
    key; ``stream`` separates the calls of one solver object."""

    def __init__(self, seed: int, device="cpu", stream: int = 0):
        self.seed = int(seed)
        self.stream = int(stream)
        self.device = torch.device(device)

    def _gen(self, *words: int, device=None) -> torch.Generator:
        g = torch.Generator(device=device or self.device)
        g.manual_seed(_mix(self.seed, self.stream, *words))
        return g

    def _normal(self, shape, dtype, *words: int) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen(*words), dtype=dtype,
                           device=self.device)

    def sketch(self, i: int, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _SKETCH, i)

    def omega(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _OMEGA)

    def gap(self, i: int, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _GAP, i)

    def rounding_rv(self, attempt: int, Z: int, D: int, dtype) -> torch.Tensor:
        return self._normal((Z, D), dtype, _ROUND, attempt)

    def fill(self, attempt: int, K: int, Z: int) -> np.ndarray:
        g = self._gen(_FILL, attempt, device="cpu")
        return torch.randint(0, max(int(Z), 1), (K,), generator=g,
                             dtype=torch.int32).numpy()

    def dense_rounding_rv(self, attempt: int, Z_pad: int, D: int,
                          dtype) -> torch.Tensor:
        return self._normal((Z_pad, D), dtype, _DENSE_RV, attempt)

    def dense_fill(self, Kp: int, Z: int) -> torch.Tensor:
        return torch.randint(0, max(int(Z), 1), (Kp,),
                             generator=self._gen(_DENSE_FILL),
                             dtype=torch.int32, device=self.device)

    def locations(self, shape, dtype) -> torch.Tensor:
        return torch.rand(shape, generator=self._gen(_LOC), dtype=dtype,
                          device=self.device)

    def directions(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _DIR)

    def mobility(self, step: int, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _MOB, step)

    def packet_loss(self, step: int, bler: torch.Tensor) -> torch.Tensor:
        g = self._gen(_PCKL, step, device=bler.device)
        return torch.bernoulli(bler, generator=g).to(torch.int32)
