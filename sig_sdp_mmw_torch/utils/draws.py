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

The device rounding of the sparse state (``models/rounding_ell.py``) keeps
its two routes' draws apart, as the JAX package does:

* ``ell_batch_rv(attempt, Z_pad, D, dtype)`` — the batched route's attempt
  slot vectors (JAX: ``split(key, nattempt)[attempt]``);
* ``ell_batch_fill(Kp, Z)``     — its one fallback draw over all Kp users
  (JAX: ``fold_in(key, 99)``);
* ``ell_attempt(attempt)``      — a draws object for one attempt of the
  sequential-retry and wavefront routes (JAX: ``fold_in(key, attempt)``),
  read through
* ``attempt_rv(Z_pad, D, dtype)`` — an attempt's slot vectors (JAX: the
  attempt's own key) and
* ``attempt_fill(Kp, Z)``       — its fallback draw (JAX: ``fold_in(key,
  99)`` of the attempt's key).

The ELL heuristics (``models/heuristics_ell.py``) draw from their own
objects (JAX: ``PRNGKey(777)`` for MAX_GAIN/MAX_ASSO, ``PRNGKey(4242)``
split in three for MAX_RAND):

* ``score_fill(Kp, Z)``         — the score heuristics' fallback slots;
* ``rand_order(base)``          — MAX_RAND's random permutation of the int
  tensor ``base``;
* ``rand_pref(Z_pad, Kp, dtype)`` — its uniform [0, 1) slot scores;
* ``rand_fill(Kp, Z)``          — its fallback slots.

The journal comparison slice draws by its own roles (the dense
heuristics reuse ``score_fill`` for MAX_GAIN/MAX_ASSO, JAX ``PRNGKey(777)``,
and ``rand_fill`` for MAX_RAND, JAX ``split(PRNGKey(4242), 3)[2]``):

* ``sdp_rand_factor(shape, dtype)`` — ``RandSDPSolver``'s Gaussian factor
  (JAX: the call's key, ``fold_in(PRNGKey(seed), n)``);
* ``spectral_start(shape, dtype)`` — ``SpectralSDPSolver``'s start block
  (JAX: ``PRNGKey(seed)``, the same on every call);
* ``lrp_fill(Kp, Z)``            — ``LRPSolver``'s fallback slots (JAX:
  ``fold_in(PRNGKey(seed), n)``);
* ``rand_gx(shape, dtype)``      — MAX_RAND's random factor [Kp, 8] (JAX:
  ``split(PRNGKey(4242), 3)[0]``);
* ``rand_rv(shape, dtype)``      — its slot vectors [Z_pad, 8] (JAX: the
  split's second key);
* ``rotation(shape, dtype)``     — the simplex rotation's Gaussian (JAX: the
  key given to ``random_rotation``).

The batched solves and probe searches (``parallel/batch.py``) derive draws
objects from draws objects:

* ``wave(w)``                   — wave (or probe round) ``w`` of a search
  (JAX: ``fold_in(key, w)``);
* ``scenario_solve(b, B)``      — instance ``b`` of ``B`` solved together
  (JAX: ``split(key, B)[b]``);
* ``scenario_round(b, B)``      — the dense rounding of candidate ``b`` of
  ``B`` (JAX: ``split(fold_in(key, 1), B)[b]``);
* ``candidate_round(attempt, cand, n)`` — rounding attempt ``attempt`` of
  candidate ``cand`` of ``n`` on the sparse state, read through
  ``attempt_rv`` and ``attempt_fill`` (JAX: ``split(fold_in(key, 1000 +
  attempt), n)[cand]``).
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
_ELL_BRV, _ELL_BFILL, _ELL_ATTEMPT, _ATTEMPT_RV, _ATTEMPT_FILL = range(11, 16)
_SCORE_FILL, _RAND_ORDER, _RAND_PREF, _RAND_FILL = range(16, 20)
_WAVE, _SCEN_SOLVE, _SCEN_ROUND, _CAND_ROUND = range(20, 24)
_SDP_RAND, _SPEC_START, _LRP_FILL, _RAND_GX, _RAND_RV, _ROT = range(24, 30)


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

    def _randint(self, n: int, Z: int, *words: int) -> torch.Tensor:
        return torch.randint(0, max(int(Z), 1), (n,),
                             generator=self._gen(*words), dtype=torch.int32,
                             device=self.device)

    def ell_batch_rv(self, attempt: int, Z_pad: int, D: int,
                     dtype) -> torch.Tensor:
        return self._normal((Z_pad, D), dtype, _ELL_BRV, attempt)

    def ell_batch_fill(self, Kp: int, Z: int) -> torch.Tensor:
        return self._randint(Kp, Z, _ELL_BFILL)

    def ell_attempt(self, attempt: int) -> "TorchDraws":
        return self._child(_ELL_ATTEMPT, attempt)

    def attempt_rv(self, Z_pad: int, D: int, dtype) -> torch.Tensor:
        return self._normal((Z_pad, D), dtype, _ATTEMPT_RV)

    def attempt_fill(self, Kp: int, Z: int) -> torch.Tensor:
        return self._randint(Kp, Z, _ATTEMPT_FILL)

    def score_fill(self, Kp: int, Z: int) -> torch.Tensor:
        return self._randint(Kp, Z, _SCORE_FILL)

    def rand_order(self, base: torch.Tensor) -> torch.Tensor:
        perm = torch.randperm(base.shape[0], generator=self._gen(_RAND_ORDER),
                              device=self.device)
        return base[perm]

    def rand_pref(self, Z_pad: int, Kp: int, dtype) -> torch.Tensor:
        return torch.rand((Z_pad, Kp), generator=self._gen(_RAND_PREF),
                          dtype=dtype, device=self.device)

    def rand_fill(self, Kp: int, Z: int) -> torch.Tensor:
        return self._randint(Kp, Z, _RAND_FILL)

    def sdp_rand_factor(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _SDP_RAND)

    def spectral_start(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _SPEC_START)

    def lrp_fill(self, Kp: int, Z: int) -> torch.Tensor:
        return self._randint(Kp, Z, _LRP_FILL)

    def rand_gx(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _RAND_GX)

    def rand_rv(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _RAND_RV)

    def rotation(self, shape, dtype) -> torch.Tensor:
        return self._normal(shape, dtype, _ROT)

    def _child(self, *words: int) -> "TorchDraws":
        return TorchDraws(self.seed, self.device,
                          stream=_mix(self.stream, *words))

    def wave(self, w: int) -> "TorchDraws":
        return self._child(_WAVE, w)

    def scenario_solve(self, b: int, B: int) -> "TorchDraws":
        return self._child(_SCEN_SOLVE, b)

    def scenario_round(self, b: int, B: int) -> "TorchDraws":
        return self._child(_SCEN_ROUND, b)

    def candidate_round(self, attempt: int, cand: int,
                        n: int) -> "TorchDraws":
        return self._child(_CAND_ROUND, attempt, cand)
