"""Shared helpers of the port's parity tests (tests/test_torch_*.py): carry
JAX containers across as numpy, hand the JAX package's random draws to the
port on the JAX schedule, and keep torch to one thread while a module runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_JNP_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while a test module runs, restored after.

    The parity inputs are small (K=300); torch's default of one thread per
    core, in each of several parallel test workers, oversubscribes the cores
    and slows the port's tests about threefold.  A module opts in by
    importing this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_fields(obj):
    """A JAX dataclass container as a dict of numpy arrays (nested
    containers as nested dicts, static ints as ints)."""
    if obj is None:
        return None
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) or v is None:
            out[f.name] = jax_fields(v)
        elif isinstance(v, int):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def to_torch(x):
    return torch.from_numpy(np.array(x))


class JaxDraws:
    """The draws of ``sig_sdp_mmw_tpu`` for one solve (``mmw_solve`` /
    ``mmw_solve_ell``'s ``key``), one rounding (``rounding_native_csr``'s,
    ``rounding_ell``'s or the dense ``rounding``'s ``key``; ``nattempt`` for
    the batched ones), one heuristic (``PRNGKey(777)``, ``PRNGKey(4242)``)
    or one probe search (``fold_in(PRNGKey(seed), ncall)``), by role, on the
    JAX package's key schedule."""

    def __init__(self, key, nit: int = 0, nattempt: int = 10):
        self.key = key
        self.nit = nit
        self.nattempt = nattempt

    def _normal(self, k, shape, dtype):
        return to_torch(jax.random.normal(k, shape, _JNP_DTYPE[dtype]))

    def sketch(self, i, shape, dtype):
        return self._normal(jax.random.fold_in(self.key, i), shape, dtype)

    def omega(self, shape, dtype):
        return self._normal(jax.random.fold_in(self.key, self.nit + 1),
                            shape, dtype)

    def gap(self, i, shape, dtype):
        return self._normal(jax.random.fold_in(self.key, 2 * self.nit + 7 + i),
                            shape, dtype)

    def rounding_rv(self, attempt, Z, D, dtype):
        return self._normal(jax.random.fold_in(self.key, attempt), (Z, D),
                            dtype)

    def fill(self, attempt, K, Z):
        k = jax.random.fold_in(jax.random.fold_in(self.key, attempt), 99)
        return np.asarray(jax.random.randint(k, (K,), 0, max(int(Z), 1),
                                             jnp.int32))

    def dense_rounding_rv(self, attempt, Z_pad, D, dtype):
        k = jax.random.split(self.key, self.nattempt)[attempt]
        return self._normal(k, (Z_pad, D), dtype)

    def dense_fill(self, Kp, Z):
        k = jax.random.fold_in(self.key, 99)
        return to_torch(jax.random.randint(k, (Kp,), 0, max(int(Z), 1),
                                           jnp.int32))

    def _randint(self, k, n, Z):
        return to_torch(jax.random.randint(k, (n,), 0, max(int(Z), 1),
                                           jnp.int32))

    def ell_batch_rv(self, attempt, Z_pad, D, dtype):
        return self.dense_rounding_rv(attempt, Z_pad, D, dtype)

    def ell_batch_fill(self, Kp, Z):
        return self.dense_fill(Kp, Z)

    def ell_attempt(self, attempt):
        return self._child(jax.random.fold_in(self.key, attempt))

    def attempt_rv(self, Z_pad, D, dtype):
        return self._normal(self.key, (Z_pad, D), dtype)

    def attempt_fill(self, Kp, Z):
        return self._randint(jax.random.fold_in(self.key, 99), Kp, Z)

    def score_fill(self, Kp, Z):
        return self._randint(self.key, Kp, Z)

    def rand_order(self, base):
        k1 = jax.random.split(self.key, 3)[0]
        return to_torch(jax.random.permutation(k1, jnp.asarray(base.numpy())))

    def rand_pref(self, Z_pad, Kp, dtype):
        # JAX's default float dtype, as MAX_RAND_ELL draws them.
        k2 = jax.random.split(self.key, 3)[1]
        return to_torch(jax.random.uniform(k2, (Z_pad, Kp)))

    def rand_fill(self, Kp, Z):
        return self._randint(jax.random.split(self.key, 3)[2], Kp, Z)

    def _child(self, k):
        return JaxDraws(k, self.nit, self.nattempt)

    def wave(self, w):
        return self._child(jax.random.fold_in(self.key, w))

    def scenario_solve(self, b, B):
        return self._child(jax.random.split(self.key, B)[b])

    def scenario_round(self, b, B):
        return self._child(jax.random.split(jax.random.fold_in(self.key, 1),
                                            B)[b])

    def candidate_round(self, attempt, cand, n):
        return self._child(jax.random.split(
            jax.random.fold_in(self.key, 1000 + attempt), n)[cand])
