"""Port parity: random rotations and the regular simplex
(sig_sdp_mmw_torch.ops.simplex vs sig_sdp_mmw_tpu.ops.simplex), float64:
the vertices within 1e-12 of the JAX ones, with unit norms and pairwise
products -1/(Z-1); the rotation orthogonal and equal to the JAX one on the
JAX draw; the rotated embedding equal to the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.ops import simplex as js
from sig_sdp_mmw_torch.ops import simplex as ts
from torch_jax_parity import JaxDraws
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("Z", [2, 3, 8, 17])
def test_regular_simplex_vertices(Z):
    Vt = ts.regular_simplex_vertices(Z, torch.float64).numpy()
    Vj = np.asarray(js.regular_simplex_vertices(Z, jnp.float64))
    assert Vt.shape == (Z, Z - 1)
    np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-12)
    G = Vt @ Vt.T
    np.testing.assert_allclose(np.diag(G), 1.0, atol=1e-12)
    off = G[~np.eye(Z, dtype=bool)]
    np.testing.assert_allclose(off, -1.0 / (Z - 1), atol=1e-12)


@pytest.mark.parametrize("n", [4, 16])
def test_random_rotation_matches_jax(n):
    key = jax.random.PRNGKey(3)
    Rt = ts.random_rotation(JaxDraws(key), n, torch.float64).numpy()
    Rj = np.asarray(js.random_rotation(key, n, jnp.float64))
    np.testing.assert_allclose(Rt @ Rt.T, np.eye(n), atol=1e-12)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("Z,D", [(4, 3), (6, 12)])
def test_rotated_simplex_matches_jax(Z, D):
    key = jax.random.PRNGKey(7)
    Et = ts.generate_rand_regular_simplex_with_Z_vertices(
        Z, D, JaxDraws(key), torch.float64, device="cpu").numpy()
    Ej = np.asarray(js.generate_rand_regular_simplex_with_Z_vertices(
        Z, D, key, jnp.float64))
    assert Et.shape == (Z, D)
    np.testing.assert_allclose(Et, Ej, rtol=0, atol=1e-12)
    off = (Et @ Et.T)[~np.eye(Z, dtype=bool)]
    np.testing.assert_allclose(off, -1.0 / (Z - 1), atol=1e-12)


def test_simplex_needs_enough_dimensions():
    with pytest.raises(ValueError):
        ts.generate_rand_regular_simplex_with_Z_vertices(5, 3, device="cpu")
    E = ts.generate_rand_regular_simplex_with_Z_vertices(5, 4, device="cpu")
    assert E.shape == (5, 4) and E.device.type == "cpu"
