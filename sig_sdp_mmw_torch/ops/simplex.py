"""Random rotations and regular simplex embeddings.

Port of :mod:`sig_sdp_mmw_tpu.ops.simplex` (reference ``sim_src/
linalg_util.py``): a random rotation via QR (``:4-14``) and the random
regular Z-vertex simplex embedded in R^D (``:15-35``), the geometric object
behind the SDP's "different slot" encoding (X_ij <= -1/(Z-1) is the pairwise
inner product of simplex vertices).  The rotation's Gaussian is the draws
object's ``rotation`` (:mod:`sig_sdp_mmw_torch.utils.draws`).
"""

from __future__ import annotations

import torch

from sig_sdp_mmw_torch.utils.draws import TorchDraws


def random_rotation(draws, n: int, dtype=torch.float32) -> torch.Tensor:
    """Haar-ish random orthogonal matrix via QR of a Gaussian."""
    A = draws.rotation((n, n), dtype)
    Q, R = torch.linalg.qr(A)
    # Fix the sign ambiguity so the distribution is uniform.
    return Q * torch.sign(torch.diagonal(R))[None, :]


def regular_simplex_vertices(Z: int, dtype=torch.float32,
                             device="cpu") -> torch.Tensor:
    """[Z, Z-1] coordinates of a regular simplex with unit vertices:
    pairwise inner products are exactly -1/(Z-1)."""
    eye = torch.eye(Z, dtype=dtype, device=device)
    centered = eye - 1.0 / Z
    # Orthonormal basis of the sum-zero subspace via QR of the centering map.
    Q, _ = torch.linalg.qr(centered[:, : Z - 1])
    V = centered @ Q
    return V / torch.linalg.norm(V, dim=1, keepdim=True)


def generate_rand_regular_simplex_with_Z_vertices(Z: int, D: int, draws=None,
                                                  dtype=torch.float32,
                                                  device="cuda"
                                                  ) -> torch.Tensor:
    """[Z, D] randomly rotated regular simplex (reference
    ``linalg_util.py:15-35``) on ``device``; ``draws`` defaults to seed 0."""
    if D < Z - 1:
        raise ValueError("need D >= Z-1 to embed a Z-simplex")
    if draws is None:
        draws = TorchDraws(0, device)
    V = regular_simplex_vertices(Z, dtype, device)          # [Z, Z-1]
    pad = torch.zeros((Z, D - (Z - 1)), dtype=dtype, device=device)
    V = torch.cat([V, pad], dim=1)
    R = random_rotation(draws, D, dtype).to(device)
    return V @ R
