"""The plain reference's bound read by its parts: the solve of
:func:`portbench.reference.mmw.ub_final`, step for step, returning the
averaged primal's worst violation of each constraint block (the diagonal,
the association pairs, the interference budgets) in place of their max.

Far above the answer the diagonal's part is the bound, and it follows the
sketches more than the operator's products; the budgets' part reads every
product of S̃, so it shows a change of the products' precision there too.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.mmw import (_csr, expm_apply, lanczos_m, rounder,
                                     sketch)


def ub_parts(St, edges, h, Z, *, nit: int, eta: float, rank_radio: int,
             Kp: int, D_pad: int, seed: int, stream: int, device,
             low=None) -> list:
    """[diagonal, association, budgets]: the worst violation of each block
    of the averaged primal of the solve at ``Z`` slots, as
    :func:`portbench.reference.mmw.ub_final` solves it (same arguments);
    the association's part is -inf without association pairs.  Their max
    is ``ub_final``."""
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

    def L_apply(d, f, hr):
        fr = r(f)

        def apply(V):
            Vr = r(V)
            t = d[:, None] * V
            t = t.index_add(0, ai, fr[:, None] * Vr[aj])
            t = t.index_add(0, aj, fr[:, None] * Vr[ai])
            t = t + hr[:, None] * (A @ Vr)
            return t + At @ r(hr[:, None] * V)

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
        xH = torch.sum(X * (A @ r(X)), dim=1) / tr
    eD, eF, eH = violations(sm / nit, sF / nit, sH / nit)
    return [float(torch.max(eD)),
            float(torch.max(eF)) if E else -float("inf"),
            float(torch.max(eH))]
