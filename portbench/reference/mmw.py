"""The plain reference of the MMW feasibility solve: its bound ``ub_final``
at a probed Z, in float64 PyTorch.

A straightforward implementation of the published algorithm (SIG-SDP,
arXiv:2501.11307; zhouyou-gu/sig-sdp-mmw ``sim_src/alg/mmw.py``): ``nit``
rounds of the dual softmax over the three constraint blocks (the diagonal,
the association pairs, the interference budgets), the accumulated loss, and
the primal as the trace-normalised Gibbs state exp(L/2) G, where G is the
iteration's Gaussian sketch and exp(L/2) G comes from an m-step Lanczos
recurrence; ``ub_final`` is the largest violation of the averaged primal.

It works on the reference's own state (S̃ = Sᵀ without the diagonal and the
association pairs, the association edges, the budgets), never on anything
the program built.  The sketches are random inputs: :func:`sketch` draws
them with the same recipe (a splitmix64 seed per (seed, stream, iteration)
and ``torch.randn`` on the run's device), so both sides solve with the same
sketches.  ``low`` computes every operator product from operands rounded to
a lower precision (``bfloat16`` or ``float8_e4m3fn``, per-tensor scaled):
the correctness control.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.sparse
import torch

_MASK64 = (1 << 64) - 1
_SKETCH = 0                          # the sketch's role word in the recipe
_F8_MAX = 448.0                      # largest float8_e4m3fn


def _mix(*words: int) -> int:
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h >> 1


def sketch(seed: int, stream: int, i: int, shape, device) -> torch.Tensor:
    """Iteration ``i``'s float32 Gaussian sketch of a solve (the draws of
    stream ``stream`` of ``seed``)."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(int(seed), int(stream), _SKETCH, int(i)))
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=device)


def lanczos_m(eta: float, nit: int) -> int:
    """The Krylov depth the configuration's (eta, nit) asks for."""
    return min(48, max(8, int(math.ceil(8 + 0.6 * math.sqrt(eta * nit)))))


def rounder(low):
    """x -> x rounded to ``low`` and back (identity for None)."""
    if low is None:
        return lambda x: x
    dt = getattr(torch, low)

    def r(x):
        if dt is torch.bfloat16:
            return x.to(dt).to(x.dtype)
        s = torch.clamp(torch.max(torch.abs(x)), min=1e-300) / _F8_MAX
        return (x / s).to(dt).to(x.dtype) * s

    return r


def _expm_e1(T, norm_bound: float, order: int = 12):
    """exp(T - sigma I) e1 for a batch of small symmetric T, by scaling and
    squaring a Taylor series (sigma: the largest Gershgorin bound)."""
    m = T.shape[-1]
    eye = torch.eye(m, dtype=T.dtype, device=T.device)[None]
    diag = torch.diagonal(T, dim1=-2, dim2=-1)
    sigma = torch.max(diag + torch.sum(torch.abs(T), dim=-1) - torch.abs(diag))
    M = T - sigma * eye
    s = max(0, int(math.ceil(math.log2(max(2.0 * norm_bound, 1.0)))))
    Ms = M / 2.0 ** s
    E, term = eye + Ms, Ms
    for p in range(2, order + 1):
        term = torch.bmm(term, Ms) / p
        E = E + term
    for _ in range(s):
        E = torch.bmm(E, E)
    return E[:, :, 0]


def expm_apply(matvec, V, m: int, norm_bound: float):
    """exp(A) V up to one positive scale, by m Lanczos steps per column
    with full re-orthogonalisation."""
    K, D = V.shape
    beta0 = torch.linalg.norm(V, dim=0)

    def div(x, d):
        ok = d > 0
        return torch.where(ok[None, :], x / torch.where(ok, d, 1.0)[None, :],
                           0.0)

    q = div(V, beta0)
    basis = [q]
    q_prev = torch.zeros_like(q)
    b_prev = torch.zeros(D, dtype=V.dtype, device=V.device)
    alphas, betas = [], []
    for j in range(m):
        w = matvec(q) - b_prev[None, :] * q_prev
        a = torch.sum(q * w, dim=0)
        w = w - a[None, :] * q
        for u in basis:                          # Gram-Schmidt, once
            w = w - torch.sum(u * w, dim=0)[None, :] * u
        b = torch.linalg.norm(w, dim=0)
        b = torch.where(b > 1e-8 * torch.clamp(beta0, min=1e-20), b, 0.0)
        q_prev, q, b_prev = q, div(w, b), b
        if j + 1 < m:
            basis.append(q)
        alphas.append(a)
        betas.append(b)
    a, b = torch.stack(alphas).T, torch.stack(betas).T[:, :m - 1]
    T = torch.diag_embed(a)
    off = torch.diag_embed(b, offset=1)
    T = T + off + off.transpose(-1, -2)
    c = _expm_e1(T, norm_bound) * beta0[:, None]           # [D, m]
    return sum(basis[k] * c[:, k][None, :] for k in range(m))


def s_tilde(S, Q):
    """S̃ = Sᵀ without the diagonal and the association pairs (CSR)."""
    St = scipy.sparse.csr_matrix(S).transpose().tocsr()
    St = St - St.multiply(scipy.sparse.csr_matrix(Q) != 0)
    St.setdiag(0.0)
    St.eliminate_zeros()
    return St.tocsr()


def assoc_edges(Q):
    """(i, j) of every association pair, i < j, in row order."""
    Qu = scipy.sparse.triu(scipy.sparse.csr_matrix(Q), k=1).tocsr()
    Qu.eliminate_zeros()
    c = Qu.tocoo()
    return c.row.astype(np.int64), c.col.astype(np.int64)


def _csr(M, device, r):
    M = M.tocsr()
    vals = r(torch.from_numpy(M.data.astype(np.float64)).to(device))
    with warnings.catch_warnings():      # sparse CSR is marked beta
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)).to(device),
            torch.from_numpy(M.indices.astype(np.int64)).to(device), vals,
            size=M.shape, check_invariants=False)


def ub_final(St, edges, h, Z, *, nit: int, eta: float, rank_radio: int,
             Kp: int, D_pad: int, seed: int, stream: int, device,
             low=None) -> float:
    """``ub_final`` of the solve at ``Z`` slots on the state (S̃ ``St``,
    association ``edges``, budgets ``h``) with the sketches of
    (``seed``, ``stream``) drawn as [Kp, D_pad]; float64, or the control's
    ``low`` products."""
    dev = torch.device(device)
    f64 = torch.float64
    K = St.shape[0]
    Z = float(Z)
    r = rounder(low)
    A, At = _csr(St, dev, r), _csr(St.transpose(), dev, r)
    ai = torch.from_numpy(edges[0]).to(dev)
    aj = torch.from_numpy(edges[1]).to(dev)
    h = torch.as_tensor(np.asarray(h, np.float64), device=dev)
    St2 = St.tocsr()
    S_sum = torch.as_tensor(np.asarray(St2.sum(axis=1)).ravel(), device=dev)
    row2 = torch.as_tensor(np.asarray(St2.multiply(St2).sum(axis=1)).ravel(),
                           device=dev)
    norm_H = (torch.sqrt(row2) * (Z - 1.0) / (2.0 * Z)
              + torch.abs(h / K - S_sum / (K * Z)))
    norm_H = torch.where(norm_H > 0, norm_H, 1.0)
    cF = 1.0 / (0.5 + 1.0 / (K * (Z - 1.0)))
    D_act = min(int(Z * rank_radio), D_pad)
    m = lanczos_m(eta, nit)
    E = ai.shape[0]

    def zeros(n):
        return torch.zeros(n, dtype=f64, device=dev)

    def violations(md, xF, xH):
        eD = (md - 1.0) / (1.0 - 1.0 / K)
        eF = (xF + 1.0 / (Z - 1.0)) / (1.0 / (K * (Z - 1.0)) + 0.5)
        eH = (xH * (Z - 1.0) / Z - (h - S_sum / Z)) / norm_H
        return eD, eF, eH

    def spmm(M, V):
        return M @ r(V)

    def L_apply(d, f, hr):
        fr = r(f)

        def apply(V):
            Vr = r(V)
            t = d[:, None] * V
            t = t.index_add(0, ai, fr[:, None] * Vr[aj])
            t = t.index_add(0, aj, fr[:, None] * Vr[ai])
            t = t + hr[:, None] * spmm(A, V)
            return t + spmm(At, hr[:, None] * V)

        return apply

    eaD, eaF, eaH = zeros(K), zeros(E), zeros(K)
    d_acc, f_acc, h_acc = zeros(K), zeros(E), zeros(K)
    md, xF, xH = torch.ones(K, dtype=f64, device=dev), zeros(E), zeros(K)
    sm, sF, sH = zeros(K), zeros(E), zeros(K)
    for i in range(nit):
        sm, sF, sH = sm + md, sF + xF, sH + xH       # average, pre-update
        eD, eF, eH = violations(md, xF, xH)
        eaD, eaF, eaH = eaD + eta * eD, eaF + eta * eF, eaH + eta * eH
        e = torch.cat([eaD, eaF, eaH])
        y = torch.exp(e - torch.max(e))
        y = y / torch.sum(y)
        YD, YF, YH = y[:K], y[K:K + E], y[K + E:]
        ld = (YD - torch.sum(YD) / K) / (1.0 - 1.0 / K)
        coef = YH / norm_H
        d = (ld + torch.sum(YF) / (K * (Z - 1.0)) * cF
             - torch.sum((h / K - S_sum / (K * Z)) * coef))
        d_acc = d_acc - eta * d
        f_acc = f_acc - eta * YF * cF * 0.5
        h_acc = h_acc - eta * coef * (Z - 1.0) / (2.0 * Z)
        L = L_apply(d_acc, f_acc, h_acc)
        G = sketch(seed, stream, i, (Kp, D_pad), dev)[:K].to(f64)
        G[:, D_act:] = 0.0
        rn = torch.linalg.norm(G, dim=1, keepdim=True)
        G = torch.where(rn > 0, G / torch.where(rn > 0, rn, 1.0), 0.0)
        X = expm_apply(lambda V: 0.5 * L(V), G, m, eta * nit)
        tr = torch.sum(X * X) / K
        md = torch.sum(X * X, dim=1) / tr
        xF = torch.sum(X[ai] * X[aj], dim=1) / tr
        xH = torch.sum(X * spmm(A, X), dim=1) / tr
    eD, eF, eH = violations(sm / nit, sF / nit, sH / nit)
    worst = [torch.max(eD), torch.max(eH)] + ([torch.max(eF)] if E else [])
    return float(max(worst))
