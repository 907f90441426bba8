"""Action of the matrix exponential by batched Lanczos (port of
:mod:`sig_sdp_mmw_tpu.ops.expm`).

All D sketch columns run their Lanczos recurrences together, so each step is
one operator apply to a [K, D] block; the m x m tridiagonal exponentials are
taken in the small Krylov space; results carry a global log-scale,
``expm(A) @ V = exp(sigma) * F``, which the trace-normalized Gibbs state of
MMW never needs to exponentiate.  The Krylov dimension m is fixed from the
analytic bound ``||L_accu/2|| <= eta * nit``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from sig_sdp_mmw_torch.utils.profiling import span

MatVec = Callable[[torch.Tensor], torch.Tensor]  # [K, D] -> [K, D], symmetric


def default_lanczos_iters(norm_bound: float) -> int:
    """Static Krylov dimension for a spectral-norm bound."""
    m = int(math.ceil(1.25 * norm_bound
                      + 8.0 * math.sqrt(max(norm_bound, 1.0))))
    return max(8, min(m, 96))


def _expm_e1_batched_sym(T: torch.Tensor, norm_bound: float,
                         taylor_order: int = 12
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exp(T - sigma I) @ e1`` for a batch of small symmetric matrices by a
    static scaling-and-squaring Taylor series with a global Gershgorin
    shift; ``norm_bound`` fixes the squaring count.

    Returns (y [D, m], sigma): the true value is ``exp(sigma) * y``.
    """
    D, m, _ = T.shape
    eye = torch.eye(m, dtype=T.dtype, device=T.device)[None]
    diag = torch.diagonal(T, dim1=-2, dim2=-1)
    radii = torch.sum(torch.abs(T), dim=-1) - torch.abs(diag)
    sigma = torch.max(diag + radii)
    M = T - sigma * eye

    s = max(0, int(math.ceil(math.log2(max(2.0 * norm_bound, 1.0)))))
    Ms = M / (2.0 ** s)

    E = eye + Ms
    term = Ms
    for p in range(2, taylor_order + 1):
        term = torch.bmm(term, Ms) / p
        E = E + term
    for _ in range(s):
        E = torch.bmm(E, E)
    return E[:, :, 0], sigma


def _safe_div(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Divide columns of x by d, giving 0 for non-positive d."""
    d_ok = d > 0
    den = torch.where(d_ok, d, torch.ones_like(d))
    return torch.where(d_ok[None, :], x / den[None, :], torch.zeros_like(x))


def lanczos_tridiag(matvec: MatVec, V: torch.Tensor, m: int,
                    reorth: bool = True):
    """The shared m-step batched Lanczos recurrence over the D columns of V.

    Returns ``(Q, alphas, betas, beta0)``: the Krylov bases [m, K, D], the
    tridiagonal coefficients [m, D] (betas[j] couples q_j and q_{j+1}), and
    the initial column norms [D].

    The bases are stored column-major, [D, m, K] (``Q`` is a permuted view
    of it), so the re-orthogonalization is two batched products over the D
    columns that read the basis in place — an einsum over an [m, K, D]
    basis copies all of it twice per step.  Each step's
    re-orthogonalization is a ``lanczos.reorth`` span (timed on a card).
    """
    K, D = V.shape
    dtype, device = V.dtype, V.device
    beta0 = torch.linalg.norm(V, dim=0)
    q0 = _safe_div(V, beta0)
    Qt = torch.zeros((D, m, K), dtype=dtype, device=device)
    Qt[:, 0, :] = q0.T
    steps = torch.arange(m, device=device)
    q_prev = torch.zeros_like(q0)
    q = q0
    beta_prev = torch.zeros((D,), dtype=dtype, device=device)
    alphas, betas = [], []
    for j in range(m):
        w = matvec(q) - beta_prev[None, :] * q_prev
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha[None, :] * q
        if reorth:
            with span("lanczos.reorth", timed=True):
                proj = torch.bmm(Qt, w.T.unsqueeze(-1))        # [D, m, 1]
                proj = torch.where((steps <= j)[None, :, None], proj,
                                   torch.zeros_like(proj))
                w = w - torch.bmm(Qt.transpose(1, 2), proj)[:, :, 0].T
        beta = torch.linalg.norm(w, dim=0)
        # Happy breakdown: invariant subspace found -> stop extending.
        alive = beta > 1e-8 * torch.clamp(beta0, min=1e-20)
        beta_out = torch.where(alive, beta, torch.zeros_like(beta))
        q_next = _safe_div(w, beta_out)
        if j + 1 < m:
            Qt[:, j + 1, :] = q_next.T
        alphas.append(alpha)
        betas.append(beta_out)
        q_prev, q, beta_prev = q, q_next, beta_out
    return (Qt.permute(1, 2, 0), torch.stack(alphas), torch.stack(betas),
            beta0)


def lanczos_expm_multiply(matvec: MatVec, V: torch.Tensor, m: int,
                          reorth: bool = True, small_method: str = "eigh",
                          norm_bound: float = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expm(A) @ V ~= exp(sigma) * F`` via m-step batched Lanczos.

    ``small_method``: ``"taylor_ss"`` (matmul-only small exponential, see
    :func:`_expm_e1_batched_sym`) or ``"eigh"``.  Returns (F [K, D], sigma),
    one sigma for every column.
    """
    if small_method not in ("taylor_ss", "eigh"):
        raise ValueError(
            f"small_method must be 'taylor_ss' or 'eigh', got {small_method!r}")
    Q, alphas, betas, beta0 = lanczos_tridiag(matvec, V, m, reorth=reorth)

    a = alphas.T                                              # [D, m]
    b = betas.T[:, : m - 1]                                   # [D, m-1]
    T = torch.diag_embed(a)
    off = torch.diag_embed(b, offset=1)
    T = T + off + off.transpose(-1, -2)

    if small_method == "taylor_ss":
        nb = norm_bound if norm_bound is not None else float(m)
        coeff, sigma = _expm_e1_batched_sym(T, nb)
    else:
        theta, U = torch.linalg.eigh(T)                       # [D, m], [D, m, m]
        sigma = torch.max(theta)
        w1 = U[:, 0, :]
        coeff = torch.einsum("dmn,dn,dn->dm", U, torch.exp(theta - sigma), w1)
    coeff = coeff * beta0[:, None]
    # F[k, d] = sum_m Q[m, k, d] coeff[d, m], batched over d on the [D, m, K]
    # storage of the bases.
    F = torch.bmm(coeff[:, None, :], Q.permute(2, 0, 1))[:, 0, :].T
    return F, sigma


def taylor_expm_multiply(matvec: MatVec, V: torch.Tensor, steps: int,
                         order: int = 12) -> torch.Tensor:
    """Validation path: ``(exp(A/steps))^steps V`` with a fixed-order
    truncated Taylor series per substep.  No log-scaling — only for small
    ``||A||`` cross-checks against the Lanczos path."""
    s = float(steps)
    for _ in range(steps):
        term = V
        acc = V
        for p in range(1, order + 1):
            term = matvec(term) / (s * p)
            acc = acc + term
        V = acc
    return V
