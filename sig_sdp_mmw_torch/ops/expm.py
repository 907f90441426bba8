"""Action of the matrix exponential by batched Lanczos (port of
:mod:`sig_sdp_mmw_tpu.ops.expm`).

All D sketch columns run their Lanczos recurrences together, so each step is
one operator apply to a [K, D] block; the m x m tridiagonal exponentials are
taken in the small Krylov space; results carry a global log-scale,
``expm(A) @ V = exp(sigma) * F``, which the trace-normalized Gibbs state of
MMW never needs to exponentiate.  The Krylov dimension m is fixed from the
analytic bound ``||L_accu/2|| <= eta * nit``.

On a card each Lanczos step runs as four hand-written passes
(``ops/kernels/csrc/lanczos_step.cu``) around the operator's products, and
the basis is combined by one more; the plain versions
(:func:`lanczos_tridiag_reference`, :func:`lanczos_combine_reference`)
take CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

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


@dataclasses.dataclass(frozen=True)
class LanczosOperator:
    """The generic form of the operator the Lanczos steps apply:
    ``scale * matvec(V)``, ``matvec`` any symmetric [K, D] -> [K, D] map
    (a plain callable passed to :func:`lanczos_tridiag` is this form with
    scale 1).  On a card the step's first pass takes ``matvec``'s product
    and applies the scale itself."""

    matvec: MatVec
    scale: float = 1.0

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        P = self.matvec(V)
        return P if self.scale == 1.0 else self.scale * P


def split_sum(d: torch.Tensor, h: torch.Tensor, products, V: torch.Tensor,
              Vp: torch.Tensor, hVp: torch.Tensor) -> torch.Tensor:
    """``d*V + Q Vp + h*(S Vp) + T hVp``, added in that order over the n
    rows of V (d, h: [n]; each product cut to its first n rows): the
    operator's sum, whose order the steps' first pass repeats on a card.
    ``products``: the callables of Q, S and T; ``Vp``, ``hVp``: their
    operands, V and h*V padded."""
    n = V.shape[0]
    q_prod, s_prod, st_prod = products
    t = d[:, None] * V
    t = t + q_prod(Vp)[:n]
    t = t + h[:, None] * s_prod(Vp)[:n]
    return t + st_prod(hVp)[:n]


@dataclasses.dataclass(frozen=True)
class SplitOperator:
    """The split form: ``scale * (d*V + Q V + h*(S V) + T (h*V))``, added in
    that order, where the three products take V's operand: V (and h*V)
    padded with zero rows to ``nrows`` and held in ``operand_dtype``.

    ``d``, ``h``: [K] vectors; ``products``: the callables of Q, S and T
    (each [nrows, D] operand -> a [>= K, D] product of which the first K
    rows are used).  The plain version (:meth:`__call__`) hands the products
    V itself, padded (the block products' wrappers round it to their block
    type); on a card the steps' last pass writes the operands in
    ``operand_dtype`` (those same bits) and the first pass adds the parts."""

    d: torch.Tensor
    h: torch.Tensor
    products: Tuple[Callable, Callable, Callable]
    nrows: int
    operand_dtype: torch.dtype
    scale: float = 1.0

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        pad = self.nrows - V.shape[0]

        def padded(X):
            return F.pad(X, (0, 0, 0, pad)) if pad else X.contiguous()

        t = split_sum(self.d, self.h, self.products, V, padded(V),
                      padded(self.h[:, None] * V))
        return t if self.scale == 1.0 else self.scale * t


def _as_operator(matvec):
    if isinstance(matvec, (LanczosOperator, SplitOperator)):
        return matvec
    return LanczosOperator(matvec)


def lanczos_route(device) -> str:
    """How :func:`lanczos_tridiag` runs on ``device``: ``"kernel"`` (the
    hand-written passes, a card) or ``"plain"``."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def lanczos_tridiag_reference(matvec, V: torch.Tensor, m: int,
                              reorth: bool = True):
    """The plain PyTorch version of :func:`lanczos_tridiag` (any device).

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


_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def lanczos_tridiag(matvec, V: torch.Tensor, m: int, reorth: bool = True):
    """The shared m-step batched Lanczos recurrence over the D columns of V.

    Returns ``(Q, alphas, betas, beta0)``: the Krylov bases [m, K, D], the
    tridiagonal coefficients [m, D] (betas[j] couples q_j and q_{j+1}), and
    the initial column norms [D].

    ``matvec``: the symmetric operator, a callable [K, D] -> [K, D] or a
    :class:`LanczosOperator` (``scale * matvec``) or :class:`SplitOperator`
    (its parts).  A CPU tensor takes the plain version
    (:func:`lanczos_tridiag_reference`); a CUDA tensor (float32 or float64)
    runs each step as the hand-written passes of
    ``ops/kernels/csrc/lanczos_step.cu`` around the operator's products, or
    raises: the sum and first coefficient, the projections on the slots so
    far and the subtraction with the next coefficient (together the
    ``lanczos.reorth`` span, timed; without ``reorth`` the subtraction
    alone), and the normalisation into the next slot, which in split form
    also writes the products' next operands.  The basis is stored [m, K, D]
    (``Q`` itself); its buffers and the plan are made once per call and no
    pass reads a value back to the host.  ``lanczos_tridiag.launches``
    counts the kernels' launches (as the library counts each launch) and
    ``lanczos_tridiag.route_steps`` the steps by route (``"kernel"``,
    ``"plain"``).
    """
    if V.device.type == "cpu":
        out = lanczos_tridiag_reference(matvec, V, m, reorth)
        lanczos_tridiag.route_steps["plain"] += m
        return out
    if V.device.type != "cuda":
        raise ValueError(f"lanczos_tridiag: no kernel for device {V.device}")
    if V.dtype not in (torch.float32, torch.float64) or V.dim() != 2:
        raise ValueError(f"lanczos_tridiag: V must be a float32 or float64 "
                         f"[K, D] block, got {V.dtype} {list(V.shape)}")
    from sig_sdp_mmw_torch.ops.kernels import lanczos_step_library

    op = _as_operator(matvec)
    split = isinstance(op, SplitOperator)
    lib = lanczos_step_library()
    n0 = lib.lanczos_launches()
    K, D = V.shape
    dtype, device = V.dtype, V.device
    nrows = op.nrows if split else K
    op_code = _KERNEL_DTYPES.get(op.operand_dtype, -9) if split else -1
    plan = ctypes.create_string_buffer(lib.lanczos_plan_bytes())
    pl = ctypes.addressof(plan)
    sizes = (ctypes.c_longlong * 2)()
    stream = torch.cuda.current_stream(device).cuda_stream
    V = V.contiguous()
    with torch.cuda.device(device):
        if lib.lanczos_plan_init(pl, _KERNEL_DTYPES[dtype], op_code, K, nrows,
                                 D, m, float(op.scale), stream,
                                 ctypes.addressof(sizes)):
            raise ValueError(
                f"lanczos_tridiag: no kernel for K={K}, D={D}, m={m}, "
                f"{dtype}" + (f", {op.operand_dtype} operands of {nrows} "
                              f"rows" if split else ""))
        basis = torch.empty((m, K, D), dtype=dtype, device=device)
        coefs = torch.empty((3 * m + 1, D), dtype=dtype, device=device)
        work = torch.empty((2 * K * D + sizes[0],), dtype=dtype,
                           device=device)
        counters = torch.zeros((sizes[1],), dtype=torch.int32, device=device)
        if split:
            ops_ = torch.empty((2, nrows, D), dtype=op.operand_dtype,
                               device=device)
            opq, ophq = ops_[0], ops_[1]
            d, h = op.d.contiguous(), op.h.contiguous()
            q_prod, s_prod, st_prod = op.products
            ptrs = (d.data_ptr(), h.data_ptr(), opq.data_ptr(),
                    ophq.data_ptr())
        else:
            ptrs = (None, None, None, None)
        rc = lib.lanczos_plan_bind(pl, basis.data_ptr(), coefs.data_ptr(),
                                   work.data_ptr(), counters.data_ptr(),
                                   *ptrs)
        if rc:
            raise ValueError(f"lanczos_tridiag: buffers refused ({rc})")
        rc = lib.lanczos_start_launch(pl, V.data_ptr())
        for j in range(m):
            if split:
                Pq, Ps, Pst = q_prod(opq), s_prod(opq), st_prod(ophq)
                rc |= lib.lanczos_sum_launch(
                    pl, j, Pq.data_ptr(), Pq.stride(0), Ps.data_ptr(),
                    Ps.stride(0), Pst.data_ptr(), Pst.stride(0))
            else:
                P = op.matvec(basis[j])
                if P.stride(-1) != 1:
                    P = P.contiguous()
                rc |= lib.lanczos_sum_launch(pl, j, P.data_ptr(),
                                             P.stride(0), None, 0, None, 0)
            if reorth:
                with span("lanczos.reorth", timed=True):
                    rc |= lib.lanczos_project_launch(pl, j)
                    rc |= lib.lanczos_subtract_launch(pl, j, j + 1)
            else:
                rc |= lib.lanczos_subtract_launch(pl, j, 0)
            if j + 1 < m:
                rc |= lib.lanczos_normalize_launch(pl, j)
    if rc:
        raise RuntimeError(f"lanczos_tridiag: a launch failed with "
                           f"cudaError {rc}")
    lanczos_tridiag.launches += lib.lanczos_launches() - n0
    lanczos_tridiag.route_steps["kernel"] += m
    return basis, coefs[:m], coefs[m:2 * m], coefs[3 * m]


lanczos_tridiag.launches = 0
lanczos_tridiag.route_steps = {"kernel": 0, "plain": 0}


def lanczos_combine_reference(Q: torch.Tensor, coeff: torch.Tensor
                              ) -> torch.Tensor:
    """F[k, d] = sum_i Q[i, k, d] coeff[d, i], batched over d (the plain
    version of :func:`lanczos_combine`)."""
    return torch.bmm(coeff[:, None, :], Q.permute(2, 0, 1))[:, 0, :].T


def lanczos_combine(Q: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """F [K, D] = sum_i coeff[:, i] * Q[i] of a basis Q [m, K, D] and
    coefficients coeff [D, m].  A CPU tensor takes the plain version; a
    CUDA one a pass of ``lanczos_step.cu`` (counted in
    ``lanczos_tridiag.launches``), which writes F contiguous."""
    if Q.device.type == "cpu":
        return lanczos_combine_reference(Q, coeff)
    from sig_sdp_mmw_torch.ops.kernels import lanczos_step_library

    m, K, D = Q.shape
    Q, coeff = Q.contiguous(), coeff.contiguous()
    F_out = torch.empty((K, D), dtype=Q.dtype, device=Q.device)
    lib = lanczos_step_library()
    n0 = lib.lanczos_launches()
    with torch.cuda.device(Q.device):
        rc = lib.lanczos_combine_launch(
            _KERNEL_DTYPES.get(Q.dtype, -9), Q.data_ptr(), coeff.data_ptr(),
            F_out.data_ptr(), K, D, m,
            torch.cuda.current_stream(Q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"lanczos_combine: launch failed with cudaError "
                           f"{rc} (K={K}, D={D}, m={m}, {Q.dtype})")
    lanczos_tridiag.launches += lib.lanczos_launches() - n0
    return F_out


def lanczos_expm_multiply(matvec, V: torch.Tensor, m: int,
                          reorth: bool = True, small_method: str = "eigh",
                          norm_bound: float = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expm(A) @ V ~= exp(sigma) * F`` via m-step batched Lanczos
    (``matvec`` as :func:`lanczos_tridiag` takes it).

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
    return lanczos_combine(Q, coeff), sigma


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
