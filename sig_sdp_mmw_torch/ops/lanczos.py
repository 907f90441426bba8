"""Fixed-iteration Lanczos extreme-eigenvalue estimation (port of
:mod:`sig_sdp_mmw_tpu.ops.lanczos`): the m-step recurrence of
:func:`sig_sdp_mmw_torch.ops.expm.lanczos_tridiag` from one start vector,
then the Ritz values of the tridiagonal."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from sig_sdp_mmw_torch.ops.expm import lanczos_tridiag


def lanczos_extreme_eigs(matvec: Callable[[torch.Tensor], torch.Tensor],
                         v: torch.Tensor, m: int = 32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lambda_min, lambda_max) Ritz estimates of a symmetric operator.

    ``v`` [n, 1] is the start vector (a Gaussian draw; the JAX version
    draws it from its key inside)."""
    _, alphas, betas, _ = lanczos_tridiag(matvec, v, m, reorth=True)
    a = alphas[:, 0]
    b = betas[: m - 1, 0]
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    theta = torch.linalg.eigvalsh(T)
    return theta[0], theta[-1]
