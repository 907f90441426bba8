"""Sparse (ELL / block-sparse) MMW solver — the 100k-link backend, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.models.mmw_ell`: the same algorithm, with every
O(K^2) object kept implicit:

* the accumulated loss ``L_accu`` is a diagonal vector, a per-association-edge
  value vector and a per-row coefficient on the fixed S̃ pattern;
* the primal X is the sketch factor ``X_half`` plus its pattern-restricted
  edge values; the Lanczos matvec applies the implicit L in O(nnz * D);
* the averaged primal accumulates on the S̃ pattern, and the final low-rank
  factor comes from randomized subspace iteration on the implicit operator.

With block operands whose ``s_flat`` is set, every S̃ and S̃ᵀ matvec goes
through :func:`sig_sdp_mmw_torch.ops.bcsr.bsr_spmm_flat` (the flat CUDA
kernel on the card); without it, and for the association operator and the
epilogue, block products go through :func:`sig_sdp_mmw_torch.ops.bcsr.
bcsr_spmm` (the block-ELL CUDA kernel on the card).  The iteration loop is a
Python loop that can run in segments passing a carry (the million-link
driver's mode); random draws come from a draws object
(:mod:`sig_sdp_mmw_torch.utils.draws`), by absolute iteration index.

With a mesh's graph axis (``graph``), each rank holds a row shard of the
block operands (:func:`sig_sdp_mmw_torch.ops.bcsr.shard_rows`) and of the
O(nnz) accumulators; every operator apply is the product on its rows
followed by one all-gather, and the O(K) vectors and [Kp, D] blocks stay
replicated, bit for bit the same on every rank.

Spans (:func:`sig_sdp_mmw_torch.utils.profiling.span`, recorded only while
a profiler runs): ``mmw_ell.solve`` around a call, with its
:func:`sig_sdp_mmw_torch.models.mmw.solve_record`; inside it, each
iteration's ``mmw_ell.dual``, ``mmw_ell.loss``, ``mmw_ell.sketch``,
``mmw_ell.expm`` (its ``lanczos`` attribute ``"kernel"`` where the
Lanczos steps run as the hand-written passes, ``"plain"`` elsewhere),
``mmw_ell.primal`` and ``mmw_ell.gram``, then
``mmw_ell.factor`` (the bound and the factorisation; timed on a card).
With block operands each product of a block operand is a
``bcsr.spmm`` span, its ``operand`` named as
``portbench/reference/roofline.solve_products`` names it (``St``, ``StT``,
``Q``) and its width ``D``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sig_sdp_mmw_torch.models.mmw import (mmw_default_lanczos_m,
                                          solve_record, solve_span)
from sig_sdp_mmw_torch.ops.ell import ell_edge_gather_dot, ell_spmm
from sig_sdp_mmw_torch.ops.expm import (LanczosOperator, SplitOperator,
                                        lanczos_expm_multiply, lanczos_route,
                                        split_sum)
from sig_sdp_mmw_torch.ops.lanczos import lanczos_extreme_eigs
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.profiling import span
from sig_sdp_mmw_torch.utils.stats import StatsObject
from sig_sdp_mmw_torch.utils.tensors import TensorFields


@dataclasses.dataclass(frozen=True)
class MMWEllOutput(TensorFields):
    X_half: torch.Tensor    # [Kp, rank_pad]
    ub_final: torch.Tensor  # scalar
    gap_log: torch.Tensor   # [nit, 2] (UB, LB) if log_gap else [0, 2]


def _q_apply(ell, rows: slice, edge_vals, V):
    """Rows ``rows`` of the symmetric association-edge operator,
    gather-only: out[i] += sum_n edge_vals[q_eidx[i,n]] * V[q_cols[i,n]]."""
    ev = torch.where(ell.q_mask[rows], edge_vals[ell.q_eidx[rows]], 0.0)
    return torch.einsum("kn,knf->kf", ev, V[ell.q_cols[rows]])


def _edge_dots(cols, X_rows, X_half, inv_trace):
    """[n, deg] pattern-restricted Gram values <X_rows[k],
    X_half[cols[k,d]]> of a run of rows, slot by slot."""
    out = torch.zeros(cols.shape, dtype=X_half.dtype, device=X_half.device)
    for d in range(cols.shape[1]):
        out[:, d] = torch.sum(X_rows * X_half[cols[:, d]], dim=1) * inv_trace
    return out


def _masked_max(*pairs):
    """max over the entries of each vector where its mask holds."""
    return torch.max(torch.stack([torch.max(torch.where(m, v, -torch.inf))
                                  for v, m in pairs]))


@solve_span("mmw_ell.solve")
def mmw_solve_ell(ell, Z, *, nit: int, eta: float, rank_radio: int = 2,
                  D_pad: int, rank_pad: int, draws,
                  lanczos_m: Optional[int] = None, log_gap: bool = False,
                  gap_lanczos_m: int = 32, reorth: bool = True,
                  rsvd_iters: int = 3, bcsr=None, factorize: bool = True,
                  gram_mode: str = "auto",
                  spmm_row_chunk: Optional[int] = None, carry_in=None,
                  it_start: int = 0, num_steps: Optional[int] = None,
                  return_carry: bool = False, graph=None):
    """MMW feasibility solve for Z slots on the sparse state.

    ``ell``: :class:`sig_sdp_mmw_torch.core.ell.EllState`, or ``EllSlim``
    with ``bcsr``.  ``bcsr``: optional
    :class:`sig_sdp_mmw_torch.ops.bcsr.BcsrOperands` on ``ell``'s device;
    with it every per-iteration O(nnz*D) product is block-sparse.
    ``draws``: the random draws (``sketch``, ``omega``, ``gap``).
    ``spmm_row_chunk``: block-rows per chunk of the block-ELL S̃/S̃ᵀ products
    and of the epilogue's (bounds the plain versions' transients at large
    K; the CUDA kernel needs no chunks).

    ``graph`` — the graph axis of a mesh
    (:class:`sig_sdp_mmw_torch.parallel.mesh.MeshAxis`): this rank computes
    the rows of its part (``graph.rows``: of the block-rows with ``bcsr``,
    which must then be this rank's row shard,
    :func:`sig_sdp_mmw_torch.ops.bcsr.shard_rows`; of the Kp rows of the
    replicated EllState without), and every operator apply is the product
    on those rows followed by one all-gather over the axis.  The O(nnz)
    accumulators (the Gram, the epilogue's averaged blocks) hold only the
    rank's rows; every O(K) vector and [Kp, D] block is replicated, the
    same bits on every rank.  None: one process (the whole operator).

    ``gram_mode`` — how the averaged primal accumulates on the S̃ pattern:
    ``"block"``, a float32 [Kbr, Br, maxblk*Bc] accumulator updated by one
    batched product per iteration; ``"edge"``, the O(nnz) per-edge vector of
    :func:`sig_sdp_mmw_torch.ops.bcsr.bcsr_edge_gram_accum`; ``"auto"``,
    block if that accumulator (of the whole operand) is at most 2 GiB.

    Segmented execution: run ``num_steps`` iterations (default ``nit``)
    from absolute index ``it_start``, starting from ``carry_in`` (a carry
    dict returned by an earlier call; default the fresh initial carry), and
    return that carry when ``return_carry`` (else finish with the
    averaged-primal epilogue).  Draws, the Gram gate and the gap log use the
    absolute index, so segments reproduce a single run exactly.  The carry
    holds every accumulator the epilogue reads; its Gram accumulator and gap
    log are updated in place.
    """
    from sig_sdp_mmw_torch.parallel.mesh import MeshAxis

    Kp = ell.Kp
    K = ell.K
    E_pad = ell.E_pad
    use_bcsr = bcsr is not None
    is_slim = not hasattr(ell, "s_vals")
    if is_slim and not use_bcsr:
        raise ValueError("EllSlim is only valid with the BCSR backend")
    dtype = ell.h_max.dtype if is_slim else ell.s_vals.dtype
    device = ell.mask.device
    Zf = torch.tensor(float(Z), dtype=dtype, device=device)
    mask, a_mask = ell.mask, ell.a_mask
    # Named spans of the local products when the operator is sharded.
    local_span = span if graph is not None else (
        lambda name: contextlib.nullcontext())
    graph = graph if graph is not None else MeshAxis()

    if use_bcsr:
        from sig_sdp_mmw_torch.ops.bcsr import (BlockEll,
                                                bcsr_edge_gram_accum,
                                                bcsr_spmm, bcsr_spmm_transpose,
                                                bsr_spmm_flat)

        sb = bcsr.s_blocks
        nrows = sb.ncols            # the whole operand's padded rows
        Brow, Bcol = sb.Brow, sb.B
        unit, nunits = Brow, nrows // Brow
        Kbc = nrows // Bcol
        maxblk = sb.bcols.shape[1]
        maxblkQ = bcsr.q_bcols.shape[1]
        nnz_s = bcsr.nnz            # of the rows held
        if gram_mode not in ("auto", "block", "edge"):
            raise ValueError(
                f"gram_mode must be 'auto', 'block' or 'edge', got {gram_mode!r}")
        if gram_mode == "auto":
            block_gram = nunits * Brow * maxblk * Bcol * 4 <= 2 * 2**30
        else:
            block_gram = gram_mode == "block"
    else:
        nrows, unit, nunits = Kp, 1, Kp
    r0, r1 = graph.rows(nunits)
    nloc = r1 - r0                  # block-rows (rows) held
    if use_bcsr and sb.Kb != nloc:
        raise ValueError(f"bcsr holds {sb.Kb} block-rows; part "
                         f"{graph.index} of {graph.size} is [{r0}, {r1})")
    R0, R1 = r0 * unit, r1 * unit
    rows = slice(R0, R1)
    padn = nrows - Kp

    def padV(V):
        return F.pad(V, (0, 0, 0, padn)) if padn else V.contiguous()

    def loc(v):
        """This rank's rows of a replicated [Kp] vector (zero past Kp)."""
        return (F.pad(v, (0, padn)) if padn else v)[rows]

    def gather(t):
        """[Kp, ...] from every rank's rows of the padded row space."""
        return graph.gather_rows(t, nunits, unit)[:Kp]

    if use_bcsr:
        q_dtype = sb.blocks.dtype

        def q_vals(edge_vals):
            # In the block storage dtype, like the S̃ blocks.
            flat = torch.zeros(nloc * maxblkQ * Brow * Bcol, dtype=q_dtype,
                               device=device)
            flat[bcsr.q_pos] = edge_vals[bcsr.q_eidx].to(q_dtype)
            return flat.reshape(nloc, Brow, maxblkQ, Bcol)

        def q_loc(blocks, Vp):
            with span("bcsr.spmm", operand="Q", D=Vp.shape[1]):
                return bcsr_spmm(BlockEll(bcols=bcsr.q_bcols, blocks=blocks,
                                          nrows=nloc * Brow, ncols=nrows), Vp)

        if bcsr.s_flat is not None:
            def s_loc(Vp):
                with span("bcsr.spmm", operand="St", D=Vp.shape[1]):
                    return bsr_spmm_flat(bcsr.s_flat, Vp)

            def st_loc(Vp):
                with span("bcsr.spmm", operand="StT", D=Vp.shape[1]):
                    return bsr_spmm_flat(bcsr.st_flat, Vp)
        else:
            def s_loc(Vp):
                with span("bcsr.spmm", operand="St", D=Vp.shape[1]):
                    return bcsr_spmm(sb, Vp, row_chunk=spmm_row_chunk)

            if bcsr.st_blocks is not None:
                def st_loc(Vp):
                    with span("bcsr.spmm", operand="StT", D=Vp.shape[1]):
                        return bcsr_spmm(bcsr.st_blocks, Vp,
                                         row_chunk=spmm_row_chunk)
            else:
                # S̃ᵀ not stored: scatter through S̃ (each rank's rows add
                # into every column block).
                def st_loc(Vp):
                    with span("bcsr.spmm", operand="StT", D=Vp.shape[1]):
                        return graph.sum_over(bcsr_spmm_transpose(
                            sb.bcols, sb.blocks, Vp[rows],
                            row_chunk=spmm_row_chunk, ncols=nrows))[rows]
    else:
        def q_vals(edge_vals):
            return edge_vals

        def q_loc(edge_vals, V):
            return _q_apply(ell, rows, edge_vals, V)

        def s_loc(V):
            return ell_spmm(ell.s_cols[rows], ell.s_vals[rows], V)

        def st_loc(V):
            return ell_spmm(ell.st_cols[rows], ell.st_vals[rows], V)

    if lanczos_m is None:
        lanczos_m = mmw_default_lanczos_m(eta, nit)

    # ---- preprocessing ----------------------------------------------------
    if is_slim:
        S_sum, row2 = ell.S_sum, ell.row2
    else:
        S_sum = torch.sum(ell.s_vals, dim=1)
        row2 = torch.sum(ell.s_vals * ell.s_vals, dim=1)
    norm_H = (torch.sqrt(row2) * (Zf - 1.0) / (2.0 * Zf)
              + torch.abs(ell.h_max / K - S_sum / (K * Zf)))
    norm_H = torch.where(mask & (norm_H > 0), norm_H, 1.0)

    # Sketch width D = Z*rank_radio, clamped to the padded width.
    D_act = min(int(float(Z) * rank_radio), D_pad)
    col_mask = (torch.arange(D_pad, device=device) < D_act)[None, :]

    cF = 1.0 / (0.5 + 1.0 / (K * (Zf - 1.0)))

    def masked_softmax(eD, eF, eH):
        eD = torch.where(mask, eD, -torch.inf)
        eF = torch.where(a_mask, eF, -torch.inf)
        eH = torch.where(mask, eH, -torch.inf)
        M = torch.maximum(torch.max(eD),
                          torch.maximum(torch.max(eF), torch.max(eH)))
        xD, xF, xH = torch.exp(eD - M), torch.exp(eF - M), torch.exp(eH - M)
        den = torch.sum(xD) + torch.sum(xF) + torch.sum(xH)
        return xD / den, xF / den, xH / den

    def violations(X_mdiag, xF, xH):
        eD = (X_mdiag - 1.0) / (1.0 - 1.0 / K)
        eF = (xF + 1.0 / (Zf - 1.0)) / (1.0 / (K * (Zf - 1.0)) + 0.5)
        eH = (xH * (Zf - 1.0) / Zf - (ell.h_max - S_sum / Zf)) / norm_H
        return eD, eF, eH

    def loss_pieces(YD, YF, YH):
        """Implicit loss L(Y) = diag(d) + sym-edge(f on Q) + sym(h∘S̃), as
        the three coefficient vectors L_operator takes."""
        ld = (YD - torch.sum(YD) / K) / (1.0 - 1.0 / K)
        lf_diag = torch.sum(YF) / (K * (Zf - 1.0)) * cF
        coeff = YH / norm_H
        lh_diag = -torch.sum((ell.h_max / K - S_sum / (K * Zf)) * coeff)
        d = torch.where(mask, ld + lf_diag + lh_diag, 0.0)
        f = YF * cF * 0.5
        h = coeff * (Zf - 1.0) / (2.0 * Zf)
        return d, f, h

    def products(qv):
        """The three block products of the operator, Q (values ``qv``,
        from ``q_vals``), S̃ and S̃ᵀ, on this rank's rows."""
        return (lambda Vp: q_loc(qv, Vp), s_loc, st_loc)

    def L_operator(d_accu, qv, hrow):
        """V -> implicit L_accu @ V: this rank's rows, then the all-gather.
        ``qv``: the association operator's values (``q_vals``)."""
        dl, hl = loc(d_accu), loc(hrow)

        def apply(V):
            Vp = padV(V)
            with local_span("graph.local_product"):
                t = split_sum(dl, hl, products(qv), Vp[rows], Vp,
                              padV(hrow[:, None] * V))
            return gather(t)

        return apply

    # The products' operand type in the split form: the block type where
    # every product is a kernel, whose wrapper would round V to it (the
    # transpose through S̃, plain torch, takes V as it is).
    op_dtype = (q_dtype if use_bcsr and (bcsr.s_flat is not None
                                         or bcsr.st_blocks is not None)
                else dtype)

    def lanczos_operator(d_accu, qv, hrow, scale):
        """``scale * L_operator(d_accu, qv, hrow)`` as the Lanczos steps
        take it: on one process split into its parts, so that a card's
        steps add them in their first pass and write the products' next
        operands in their last; over a graph axis the gathered product."""
        if graph.size > 1:
            return LanczosOperator(L_operator(d_accu, qv, hrow), scale)
        return SplitOperator(d=d_accu, h=hrow, products=products(qv),
                             nrows=nrows, operand_dtype=op_dtype,
                             scale=scale)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    if carry_in is not None:
        c = carry_in
    else:
        # Initial Y: uniform over the valid constraints = softmax of zeros;
        # kept so the averaged dual matches the reference's pre-update
        # accumulation.
        y0D, y0F, y0H = masked_softmax(zeros(Kp), zeros(E_pad), zeros(Kp))
        c = dict(
            eaD=zeros(Kp), eaF=zeros(E_pad), eaH=zeros(Kp),
            d_accu=zeros(Kp), f_accu=zeros(E_pad), hrow=zeros(Kp),
            X_mdiag=torch.where(mask, 1.0, 0.0).to(dtype),
            xF=zeros(E_pad), xH=zeros(Kp),
            avg_mdiag=zeros(Kp), avg_F=zeros(E_pad), avg_H=zeros(Kp),
            y_D=y0D, y_F=y0F, y_H=y0H,
            ya_D=zeros(Kp), ya_F=zeros(E_pad), ya_H=zeros(Kp),
            gap=torch.zeros((nit if log_gap else 0, 2), dtype=dtype,
                            device=device))
        if use_bcsr and block_gram:
            # Averaged primal as a float32 block accumulator (flat slot
            # axis), this rank's block-rows.
            c["avg_blocks"] = torch.zeros((nloc, Brow, maxblk * Bcol),
                                          dtype=torch.float32, device=device)
        elif use_bcsr:
            # Averaged primal on the S̃ pattern, per edge of this rank's
            # rows (last = padding sink).
            c["avg_edge"] = zeros(nnz_s + 1)
        else:
            shape = (nloc, ell.s_cols.shape[1])
            c["s_edge"] = torch.zeros(shape, dtype=dtype, device=device)
            c["st_edge"] = torch.zeros(shape, dtype=dtype, device=device)
            c["avg_s"] = torch.zeros_like(c["s_edge"])
            c["avg_st"] = torch.zeros_like(c["st_edge"])

    for i in range(it_start, it_start + (nit if num_steps is None
                                         else num_steps)):
        # Averaging (pre-update).
        avg_mdiag = c["avg_mdiag"] + c["X_mdiag"]
        avg_F = c["avg_F"] + c["xF"]
        avg_H = c["avg_H"] + c["xH"]
        ya_D = c["ya_D"] + c["y_D"]
        ya_F = c["ya_F"] + c["y_F"]
        ya_H = c["ya_H"] + c["y_H"]

        if log_gap:
            n = float(i + 1)
            eD, eF, eH = violations(avg_mdiag / n, avg_F / n, avg_H / n)
            u = _masked_max((eD, mask), (eF, a_mask), (eH, mask))
            # LB = K * lambda_min of the averaged loss, through the same
            # implicit operator the solve uses.
            d_bar, f_bar, h_bar = loss_pieces(ya_D / n, ya_F / n,
                                              ya_H / n)
            lam_min, _ = lanczos_extreme_eigs(
                lanczos_operator(d_bar, q_vals(f_bar), h_bar, 1.0),
                draws.gap(i, (Kp, 1), dtype), m=gap_lanczos_m)
            c["gap"][i, 0] = u
            c["gap"][i, 1] = lam_min * K

        # Dual.
        with span("mmw_ell.dual"):
            eD, eF, eH = violations(c["X_mdiag"], c["xF"], c["xH"])
            eaD = c["eaD"] + eta * eD
            eaF = c["eaF"] + eta * torch.where(a_mask, eF, 0.0)
            eaH = c["eaH"] + eta * eH
            YD, YF, YH = masked_softmax(eaD, eaF, eaH)

        # Loss accumulation on the implicit structure.
        with span("mmw_ell.loss"):
            ld_d, lf_f, lh_h = loss_pieces(YD, YF, YH)
            d_accu = c["d_accu"] - eta * ld_d
            f_accu = c["f_accu"] - eta * lf_f
            hrow = c["hrow"] - eta * lh_h
            L_half = lanczos_operator(d_accu, q_vals(f_accu), hrow, 0.5)

        # Primal: Gibbs-state sketch.
        with span("mmw_ell.sketch"):
            G = draws.sketch(i, (Kp, D_pad), dtype)
            G = torch.where(col_mask & mask[:, None], G, 0.0)
            rn = torch.linalg.norm(G, dim=1, keepdim=True)
            G = torch.where(rn > 0, G / torch.where(rn > 0, rn, 1.0), 0.0)

        with span("mmw_ell.expm", lanczos=lanczos_route(device)):
            X_half, _ = lanczos_expm_multiply(
                L_half, G,
                m=lanczos_m, reorth=reorth, small_method="taylor_ss",
                norm_bound=eta * nit)

        with span("mmw_ell.primal"):
            md = torch.sum(X_half * X_half, dim=1)
            X_trace = torch.sum(md) / K
            inv_tr = 1.0 / X_trace
            X_mdiag = torch.where(mask, md * inv_tr, 0.0)
            xF = torch.where(
                a_mask,
                ell_edge_gather_dot(ell.a_i, ell.a_j, X_half) * inv_tr, 0.0)
            Xp = padV(X_half)
            with local_span("graph.local_product"):
                xH = torch.sum(Xp[rows] * s_loc(Xp), dim=1) * inv_tr
            xH = gather(xH)

        new = dict(eaD=eaD, eaF=eaF, eaH=eaH, d_accu=d_accu, f_accu=f_accu,
                   hrow=hrow, X_mdiag=X_mdiag, xF=xF, xH=xH,
                   avg_mdiag=avg_mdiag, avg_F=avg_F, avg_H=avg_H,
                   y_D=YD, y_F=YF, y_H=YH, ya_D=ya_D, ya_F=ya_F, ya_H=ya_H,
                   gap=c["gap"])
        # The averaged Gram takes X_0..X_{nit-2}: the average is pre-update
        # and X_0 = I adds nothing off the diagonal, so the final X (absolute
        # index nit-1) is left out (the JAX solver multiplies it by a zero
        # gate).  Both accumulators update in place, each on this rank's
        # rows only.
        if use_bcsr:
            key = "avg_blocks" if block_gram else "avg_edge"
            new[key] = c[key]
        with span("mmw_ell.gram"):
            if use_bcsr and i < nit - 1:
                Xr = Xp[rows].reshape(nloc, Brow, D_pad)
                Xc = Xp.reshape(Kbc, Bcol, D_pad)
                if block_gram:
                    R = Xc[sb.bcols].reshape(nloc, maxblk * Bcol, D_pad)
                    Gb = torch.bmm(Xr, R.transpose(1, 2)).to(torch.float32)
                    new["avg_blocks"].addcmul_(Gb, inv_tr.to(torch.float32))
                else:
                    bcsr_edge_gram_accum(sb.bcols, Xr, Xc, bcsr.g_src,
                                         bcsr.g_dst, new["avg_edge"], inv_tr)
            elif not use_bcsr:
                new["s_edge"] = torch.where(
                    ell.s_vals[rows] != 0,
                    _edge_dots(ell.s_cols[rows], X_half[rows], X_half,
                               inv_tr), 0.0)
                new["st_edge"] = torch.where(
                    ell.st_vals[rows] != 0,
                    _edge_dots(ell.st_cols[rows], X_half[rows], X_half,
                               inv_tr), 0.0)
                new["avg_s"] = c["avg_s"] + c["s_edge"]
                new["avg_st"] = c["avg_st"] + c["st_edge"]
        c = new
    if return_carry:
        return c

    # ---- final UB + operator-based factorization ---------------------------
    with span("mmw_ell.factor", timed=True):
        avg_mdiag = c["avg_mdiag"] / nit
        avg_F = c["avg_F"] / nit
        ub_final = mmw_ell_ub_from_carry(ell, Z, c, nit)

        if not factorize:
            return MMWEllOutput(
                X_half=torch.zeros((Kp, rank_pad), dtype=dtype, device=device),
                ub_final=ub_final, gap_log=c["gap"])

        if use_bcsr:
            nslots = nloc * maxblk * Brow * Bcol
            if block_gram:
                # Masking by the scattered symmetrization weights (zero off
                # the pattern) both symmetrizes and drops non-pattern
                # positions.
                wflat = torch.zeros(nslots, dtype=torch.float32, device=device)
                wflat[bcsr.s_pos] = bcsr.w_edge.to(torch.float32)
                wavg = (c["avg_blocks"].reshape(nloc, Brow, maxblk, Bcol) / nit
                        * wflat.reshape(nloc, Brow, maxblk, Bcol)).to(q_dtype)
            else:
                avg_vals = ((c["avg_edge"][:nnz_s] / nit)
                            * bcsr.w_edge.to(dtype))
                flat = torch.zeros(nslots, dtype=q_dtype, device=device)
                flat[bcsr.s_pos] = avg_vals.to(q_dtype)
                wavg = flat.reshape(nloc, Brow, maxblk, Bcol)
            q_avg = q_vals(avg_F)
            avg_bell = BlockEll(bcols=sb.bcols, blocks=wavg, nrows=nloc * Brow,
                                ncols=nrows)

            def X_avg_apply(V):
                Vp = padV(V)
                with local_span("graph.local_product"):
                    t = loc(avg_mdiag)[:, None] * Vp[rows]
                    t = t + q_loc(q_avg, Vp)
                    with span("bcsr.spmm", operand="St", D=Vp.shape[1]):
                        t = t + bcsr_spmm(avg_bell, Vp,
                                          row_chunk=spmm_row_chunk)
                    with span("bcsr.spmm", operand="StT", D=Vp.shape[1]):
                        tt = bcsr_spmm_transpose(sb.bcols, wavg, Vp[rows],
                                                 row_chunk=spmm_row_chunk,
                                                 ncols=nrows)
                # Each rank's rows add into every column block of the
                # transpose.
                return gather(t) + graph.sum_over(tt)[:Kp]
        else:
            avg_s = c["avg_s"] / nit * ell.s_xw[rows]
            avg_st = c["avg_st"] / nit * ell.st_xw[rows]

            def X_avg_apply(V):
                with local_span("graph.local_product"):
                    t = loc(avg_mdiag)[:, None] * V[rows]
                    t = t + q_loc(avg_F, V)
                    t = t + ell_spmm(ell.s_cols[rows], avg_s, V)
                    t = t + ell_spmm(ell.st_cols[rows], avg_st, V)
                return gather(t)

        # Randomized subspace iteration on the implicit symmetric operator.
        r_ov = min(rank_pad + 8, Kp)
        Om = draws.omega((Kp, r_ov), dtype)
        Qb = torch.linalg.qr(X_avg_apply(Om))[0]
        for _ in range(rsvd_iters):
            Qb = torch.linalg.qr(X_avg_apply(X_avg_apply(Qb)))[0]
        B = Qb.T @ X_avg_apply(Qb)
        B = 0.5 * (B + B.T)
        w, Vb = torch.linalg.eigh(B)
        order = torch.argsort(-torch.abs(w), stable=True)[:rank_pad]
        w_sel = torch.abs(w[order])
        rank_act = int(min(K - 1, (float(Z) - 1.0) * rank_radio))
        keep = (torch.arange(rank_pad, device=device) < rank_act)[None, :]
        X_half = torch.where(
            keep, (Qb @ Vb[:, order]) * torch.sqrt(w_sel)[None, :], 0.0)
        X_half = torch.where(mask[:, None], X_half, 0.0)
        return MMWEllOutput(X_half=X_half, ub_final=ub_final, gap_log=c["gap"])


def mmw_ell_ub_from_carry(ell, Z, carry, n) -> torch.Tensor:
    """Max constraint violation of the n-iteration averaged primal, read
    from a segmented run's carry (the reference's LOG_GAP UB): the
    convergence curve at segment boundaries for O(Kp + E) vector math, and
    the solver's own ``ub_final`` at n = nit.  ``ell``: EllState or
    EllSlim."""
    avg_mdiag = carry["avg_mdiag"]
    dtype = avg_mdiag.dtype
    Zf = torch.tensor(float(Z), dtype=dtype, device=avg_mdiag.device)
    K = ell.K
    if hasattr(ell, "s_vals"):
        S_sum = torch.sum(ell.s_vals, dim=1)
        row2 = torch.sum(ell.s_vals * ell.s_vals, dim=1)
    else:
        S_sum, row2 = ell.S_sum, ell.row2
    norm_H = (torch.sqrt(row2) * (Zf - 1.0) / (2.0 * Zf)
              + torch.abs(ell.h_max / K - S_sum / (K * Zf)))
    norm_H = torch.where(ell.mask & (norm_H > 0), norm_H, 1.0)
    nf = float(n)
    eD = (avg_mdiag / nf - 1.0) / (1.0 - 1.0 / K)
    eF = ((carry["avg_F"] / nf + 1.0 / (Zf - 1.0))
          / (1.0 / (K * (Zf - 1.0)) + 0.5))
    eH = ((carry["avg_H"] / nf * (Zf - 1.0) / Zf - (ell.h_max - S_sum / Zf))
          / norm_H)
    return _masked_max((eD, ell.mask), (eF, ell.a_mask), (eH, ell.mask))


class MMWEll(StatsObject):
    """Solver object over the sparse state, pluggable into
    :class:`sig_sdp_mmw_torch.models.search.BinarySearchRelaxation`
    (port of :class:`sig_sdp_mmw_tpu.models.mmw_ell.MMWEll`).

    :meth:`prepare` keeps the host CSR state for the native rounding and,
    with ``use_bcsr=True``, builds the block operands on the state's
    device.  ``rounding``: ``"device"`` (the default, the JAX package's
    method) rounds on the ELL state through :func:`sig_sdp_mmw_torch.
    models.rounding_ell.rounding_ell`, on the route its Kp picks;
    ``"native"`` rounds through the C++ greedy scan on the host CSR state
    (:func:`rounding_native_csr`, the best attempt wins).
    """

    def __init__(self, nit: int = 100, rank_radio: int = 2,
                 eta: float = 0.1, log_gap: bool = False,
                 lanczos_m: Optional[int] = None, seed: int = 0,
                 use_bcsr: bool = False, nattempt: int = 10,
                 rounding: str = "device"):
        if rounding not in ("device", "native"):
            raise ValueError(f"rounding must be 'device' or 'native', got "
                             f"{rounding!r}")
        self.rounding_mode = rounding
        self.nit = nit
        self.rank_radio = rank_radio
        self.eta = eta
        self.log_gap = log_gap
        self.lanczos_m = lanczos_m
        self.use_bcsr = use_bcsr
        self.nattempt = nattempt
        self.seed = seed
        self._ncall = 0
        self._bcsr = None
        self._host = None       # (weakref(state), S, Q, h_max, StT)
        # Sticky sketch-width bucket: the first probe of a binary search
        # pins (D_pad, rank_pad), later probes reuse it (a smaller Z in a
        # wider bucket is exact — D_act masks the extra columns).  Pins hold
        # a weakref to their state, so they die with it.
        self._pinned = None     # (weakref(state), D_pad, rank_pad)
        # The same for the device rounding's slot padding: the first probe
        # pins the bucket, later (smaller-Z) probes reuse it; a smaller Z in
        # a wider pad is exact (slots >= Z are masked).
        self._pinned_zpad = None   # (weakref(state), Z_pad)
        # One record per rounding call: route, Z_pad, wavefront rounds.
        self.rounding_info = []
        # What the last solve ran as (:func:`sig_sdp_mmw_torch.models.mmw.
        # solve_record`): Z, K, D_pad, rank_pad, the draws' stream, nit.
        self.last_solve = None

    @staticmethod
    def _for_state(entry, ell) -> bool:
        return entry is not None and entry[0]() is ell

    def prepare(self, ell, S_csr, Q_csr, h_max=None, block: int = 128,
                **bcsr_kw):
        """Keep the host CSR state (``S``, ``Q``, ``h_max`` — default
        ``ell.h_max``) for the rounding; with ``use_bcsr`` also build the
        block operands (``bcsr_kw`` as in
        :func:`sig_sdp_mmw_torch.ops.bcsr.bcsr_operands_from_state`) on
        ``ell``'s device."""
        from sig_sdp_mmw_torch.core.ell import build_st_csr

        if h_max is None:
            h_max = ell.h_max[: ell.K].cpu().numpy()
        StT = build_st_csr(S_csr, Q_csr).transpose().tocsr()
        self._host = (weakref.ref(ell), S_csr, Q_csr.tocsr(),
                      np.asarray(h_max, np.float64), StT)
        self._bcsr = None
        if self.use_bcsr:
            from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state

            bcsr = bcsr_operands_from_state(S_csr, Q_csr, block=block,
                                            device=ell.mask.device, **bcsr_kw)
            if bcsr.s_blocks.nrows < ell.Kp:
                raise ValueError(
                    f"BCSR row padding ({bcsr.s_blocks.nrows}) is smaller "
                    f"than the EllState padding (Kp={ell.Kp})")
            self._bcsr = (weakref.ref(ell), bcsr)
        return self

    @property
    def bcsr(self):
        """The block operands built by :meth:`prepare` (None without)."""
        return None if self._bcsr is None else self._bcsr[1]

    def _d_pad_for(self, ell, Z: int):
        # Sketch width tracks the probe's Z (D = Z*rank_radio active
        # columns), bucketed to powers of two, capped below the matrix order.
        need = max(32, int(Z) * self.rank_radio)
        D_pad = 1 << (need - 1).bit_length()
        cap = ((ell.Kp - 1) // 16) * 16
        if cap == 0:
            cap = max(ell.Kp - 1, 1)
        if D_pad > cap:
            D_pad = cap
        return D_pad, min(D_pad, ell.Kp - 1)

    def run_with_state(self, bs_iteration: int, Z: int, ell,
                       D_pad: Optional[int] = None):
        tic = self._get_tic()
        if D_pad is None:
            D_pad, rank_pad = self._d_pad_for(ell, Z)
            if self._for_state(self._pinned, ell):
                D_pad = max(D_pad, self._pinned[1])
                rank_pad = max(rank_pad, self._pinned[2])
            self._pinned = (weakref.ref(ell), D_pad, rank_pad)
        else:
            rank_pad = min(D_pad, ell.Kp - 1)
        bcsr = None
        if self.use_bcsr:
            if not self._for_state(self._bcsr, ell):
                raise RuntimeError("use_bcsr=True: call prepare(ell, S, Q) "
                                   "first")
            bcsr = self._bcsr[1]
        self._ncall += 1
        draws = TorchDraws(self.seed, ell.mask.device, stream=self._ncall)
        self.last_solve = solve_record(float(Z), ell.K, D_pad, rank_pad,
                                       draws, self.nit)
        out = mmw_solve_ell(ell, float(Z), nit=self.nit, eta=self.eta,
                            rank_radio=self.rank_radio, D_pad=D_pad,
                            rank_pad=rank_pad, draws=draws,
                            lanczos_m=self.lanczos_m, log_gap=self.log_gap,
                            bcsr=bcsr, record=self.last_solve)
        tim = self._get_tim(tic, sync=out.X_half)
        self._add_np_log("mmw_all_it", bs_iteration,
                         np.array([Z, ell.K, tim]))
        self.last_output = out
        return True, out.X_half

    def rounding(self, Z: int, gX, ell, nattempt: Optional[int] = None):
        """Randomized rounding of ``gX``: on the ELL state's device
        (``rounding="device"``, with the sticky Z_pad pin and the draws of
        stream ``10_000_000 + ncall``, as the JAX package keys it), or
        through the native greedy scan on the host CSR state kept by
        :meth:`prepare`.  Each call appends to ``rounding_info`` the route
        taken and, on the device, Z_pad and the wavefront's rounds per
        attempt."""
        from sig_sdp_mmw_torch.models.rounding_ell import (
            default_z_pad_ell, rounding_ell, rounding_native_csr)

        nattempt = nattempt or self.nattempt
        self._ncall += 1
        if self.rounding_mode == "device":
            z_pad = default_z_pad_ell(ell, Z)
            if self._for_state(self._pinned_zpad, ell):
                z_pad = max(z_pad, self._pinned_zpad[1])
            self._pinned_zpad = (weakref.ref(ell), z_pad)
            draws = TorchDraws(self.seed, ell.mask.device,
                               stream=10_000_000 + self._ncall)
            info = {"Z_pad": z_pad}
            self.rounding_info.append(info)
            return rounding_ell(Z, gX, ell, draws, nattempt=nattempt,
                                Z_pad=z_pad, info=info)
        if not self._for_state(self._host, ell):
            raise RuntimeError("rounding needs prepare(ell, S, Q) first")
        _, S, Q, h, StT = self._host
        draws = TorchDraws(self.seed, gX.device, stream=self._ncall)
        self.rounding_info.append({"route": "native"})
        return rounding_native_csr(Z, gX, S, Q, h, draws, nattempt=nattempt,
                                   StT_csr=StT)
