"""Dense Matrix-Multiplicative-Weights SDP feasibility solver, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.models.mmw` (reference ``sim_src/alg/
mmw.py``): the ``nit``-iteration dual/loss/primal loop on the dense masked
state, as a Python loop over tensors on the state's device:

* ``scipy.sparse.linalg.expm_multiply`` -> the fixed-depth batched Lanczos
  of :func:`sig_sdp_mmw_torch.ops.expm.lanczos_expm_multiply`, each step a
  [Kp, Kp] @ [Kp, D] product (``torch.matmul``; TF32 stays off) in the
  operator's generic form, the 0.5 folded into the step, with a
  global log-scale so the trace-normalized Gibbs state is exact in float32;
* the sketch width is padded to ``D_pad`` with masked columns;
* random draws come from a draws object (:mod:`sig_sdp_mmw_torch.utils.
  draws`) by role: iteration i's sketch, the final factorization's Ω and
  iteration i's gap start vector;
* duality-gap telemetry (UB = max averaged violation, LB = K·lambda_min of
  the averaged loss by Lanczos) into an [nit, 2] tensor.

The loop reads no tensor back to the host, so it never waits for the card
on purpose (the gap log's small ``eigvalsh`` may).

Spans (:func:`sig_sdp_mmw_torch.utils.profiling.span`, recorded only while
a profiler runs): ``mmw.solve`` around a solve, with its
:func:`solve_record`; inside it, each iteration's ``mmw.dual``,
``mmw.loss``, ``mmw.expm`` (the sketch and the Lanczos exponential; its
``lanczos`` attribute ``"kernel"`` where the Lanczos steps run as the
hand-written passes, ``"plain"`` elsewhere) and
``mmw.primal`` (the normalised Gram), then ``mmw.factor`` (the bound
and the factorisation).  They bracket the
phases of :meth:`MMW.run_with_state_profiled`: ``mmw_dual``, ``mmw_loss``,
``mmw_expm`` (``mmw.expm`` and ``mmw.primal``) and ``mmw_xavg``.

Constraint system (``sdp_solver.py:153-161``):
  A_D: diag(X) = 1;  A_F: X_ij <= -1/(Z-1) on associated pairs;
  A_H: row-sums of S̃∘X bounded by the interference budget.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.core.preprocess import MMWOperands, build_mmw_operands
from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.models.base import SDPSolverBase
from sig_sdp_mmw_torch.ops.expm import (LanczosOperator,
                                        lanczos_expm_multiply, lanczos_route)
from sig_sdp_mmw_torch.ops.lanczos import lanczos_extreme_eigs
from sig_sdp_mmw_torch.ops.rsvd import randomized_symmetric_lowrank
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.profiling import span
from sig_sdp_mmw_torch.utils.stats import StatsObject
from sig_sdp_mmw_torch.utils.tensors import TensorFields


@dataclasses.dataclass(frozen=True)
class MMWOutput(TensorFields):
    X_half: torch.Tensor     # [Kp, rank_pad] final factor (masked beyond rank)
    ub_final: torch.Tensor   # max violation of the averaged X (scalar)
    gap_log: torch.Tensor    # [nit, 2] (UB, LB) if log_gap else [0, 2]
    X_avgd: torch.Tensor     # [Kp, Kp] averaged primal (diag included)


def _softmax_3(eD, eF, eH, mD, mF, mH, graph=None):
    """Softmax over the concatenation of three masked violation blocks;
    masked entries get zero weight.  With ``graph``, ``eF`` and ``mF`` are
    this rank's rows of the F block, whose max and sum are taken over the
    axis.  Returns the three weights, the shift M and the denominator."""
    eD = torch.where(mD, eD, -torch.inf)
    eF = torch.where(mF, eF, -torch.inf)
    eH = torch.where(mH, eH, -torch.inf)
    MF = torch.max(eF)
    if graph is not None:
        MF = graph.max_over(MF)
    M = torch.maximum(torch.max(eD), torch.maximum(MF, torch.max(eH)))
    xD, xF, xH = torch.exp(eD - M), torch.exp(eF - M), torch.exp(eH - M)
    sF = torch.sum(xF)
    if graph is not None:
        sF = graph.sum_over(sF)
    den = torch.sum(xD) + sF + torch.sum(xH)
    return xD / den, xF / den, xH / den, M, den


def _masked_softmax_3(eD, eF, eH, mD, mF, mH):
    """Softmax over the concatenation of three masked violation blocks;
    masked entries get zero weight."""
    return _softmax_3(eD, eF, eH, mD, mF, mH)[:3]


_ALL = slice(None)


def _diag_rows(v, rows: slice, Kp: int):
    """Rows ``rows`` of ``torch.diag`` of a [Kp] vector (``v`` holds those
    rows' entries)."""
    out = torch.zeros((v.shape[0], Kp), dtype=v.dtype, device=v.device)
    out.diagonal(rows.start or 0).copy_(v)
    return out


def _violations(X_mdiag, X_offdi, op: MMWOperands, Z, K, rows=_ALL):
    """Constraint violations of a primal iterate: eD of ``X_mdiag``, eF and
    eH of rows ``rows`` (``X_offdi`` and ``op``'s [Kp, Kp] operands then
    hold only those rows)."""
    eD = (X_mdiag - 1.0) / (1.0 - 1.0 / K)
    eF = (X_offdi + 1.0 / (Z - 1.0)) / (1.0 / (K * (Z - 1.0)) + 0.5)
    AHX = torch.sum(op.St * X_offdi, dim=1)
    eH = ((AHX * (Z - 1.0) / Z - (op.h_max[rows] - op.S_sum[rows] / Z))
          / op.norm_H[rows])
    return eD, eF, eH


def _max_violation(eD, eF, eH, op: MMWOperands, rows=_ALL):
    """The largest violation over the valid constraints (of rows ``rows``,
    which ``op.asso_ut`` then holds)."""
    m = op.mask[rows]
    return torch.maximum(
        torch.max(torch.where(m, eD, -torch.inf)),
        torch.maximum(torch.max(torch.where(op.asso_ut, eF, -torch.inf)),
                      torch.max(torch.where(m, eH, -torch.inf))))


def _loss_rows(YD, YF, YFt, sum_YF, YH, op: MMWOperands, StT, Z, K, Kp,
               rows=_ALL):
    """Rows ``rows`` of the dense loss L = LD + LF + LH for a dual weight
    vector.  ``YF``, ``YFt``, ``op.St`` and ``StT`` hold those rows of the F
    weights, of their transpose, of S̃ and of S̃ᵀ; ``sum_YF`` is the sum of
    every F weight."""
    ld = (YD - torch.sum(YD) / K) / (1.0 - 1.0 / K)             # LD diagonal
    YF_m = 0.5 * (YF + YFt)
    cF = 1.0 / (0.5 + 1.0 / (K * (Z - 1.0)))
    lf_diag = sum_YF / (K * (Z - 1.0)) * cF
    LF = YF_m * cF
    coef = YH / op.norm_H
    Mh = coef[rows, None] * op.St
    MhT = StT * coef[None, :]
    LH = (Mh + MhT) * (Z - 1.0) / (2.0 * Z)
    lh_diag = -torch.sum((op.h_max / K - op.S_sum / (K * Z)) * coef)
    diag = ld + lf_diag + lh_diag * torch.ones((Kp,), dtype=YD.dtype,
                                               device=YD.device)
    diag = torch.where(op.mask, diag, 0.0)
    return LF + LH + _diag_rows(diag[rows], rows, Kp)


def _loss_matrix(YD, YF, YH, op: MMWOperands, Z, K, Kp):
    """Dense loss L = LD + LF + LH for a dual weight vector."""
    return _loss_rows(YD, YF, YF.T, torch.sum(YF), YH, op, op.St.T, Z, K, Kp)


def solve_record(Z, K: int, D_pad: int, rank_pad: int, draws,
                 nit: int) -> dict:
    """What a solve ran as: the attributes of its ``*.solve`` span and the
    solver objects' ``last_solve`` (``stream``: the draws' stream)."""
    return dict(Z=Z, K=K, D_pad=D_pad, rank_pad=rank_pad,
                stream=getattr(draws, "stream", None), nit=nit)


def solve_span(name: str):
    """Decorator: the solve runs inside span ``name``, whose attributes
    are its :func:`solve_record` (``record=``: that record, where the
    caller has built it)."""
    def wrap(solve):
        @functools.wraps(solve)
        def spanned(state, Z, *, nit, D_pad, rank_pad, draws, record=None,
                    **kw):
            if record is None:
                record = solve_record(Z, state.K, D_pad, rank_pad, draws,
                                      nit)
            with span(name, **record):
                return solve(state, Z, nit=nit, D_pad=D_pad,
                             rank_pad=rank_pad, draws=draws, **kw)
        return spanned
    return wrap


def mmw_default_lanczos_m(eta: float, nit: int) -> int:
    """Krylov dimension default for the MMW Gibbs sketch.

    The worst-case bound ``||L_accu/2|| <= eta*nit`` is loose in practice;
    the reference measured the final max-violation unchanged from m=8 to
    m=48, so the default keeps a sqrt safety margin above a floor of 8.
    Override ``lanczos_m`` explicitly for other (eta, nit) regimes.
    """
    return min(48, max(8, int(math.ceil(8 + 0.6 * math.sqrt(eta * nit)))))


def _sketch(draws, i: int, op: MMWOperands, D_pad: int, D_act: int, dtype):
    """Iteration i's Gaussian sketch: active columns of valid rows, unit
    rows over the active columns."""
    Kp = op.mask.shape[0]
    col_mask = (torch.arange(D_pad, device=op.mask.device) < D_act)[None, :]
    G = draws.sketch(i, (Kp, D_pad), dtype)
    G = torch.where(col_mask & op.mask[:, None], G, 0.0)
    rn = torch.linalg.norm(G, dim=1, keepdim=True)
    return torch.where(rn > 0, G / torch.where(rn > 0, rn, 1.0), 0.0)


def _primal(op: MMWOperands, X_half, K, rows=_ALL):
    """(X_mdiag, X_offdi) of the trace-normalized sketch factor: the whole
    diagonal, and rows ``rows`` (which ``op.xpat`` then holds) of the rest."""
    md = torch.sum(X_half * X_half, dim=1)
    X_trace = torch.sum(md) / K
    X_mdiag = torch.where(op.mask, md / X_trace, 0.0)
    Gram = (X_half[rows] @ X_half.T) / X_trace
    return X_mdiag, torch.where(op.xpat, Gram, 0.0)


def _factor(X_avgd, op: MMWOperands, Z: float, K: int, rank_radio: int,
            rank_pad: int, draws):
    """X_half = U sqrt(s) of the averaged primal, rank (Z-1)·rank_radio."""
    rank_act = int(min(K - 1, (Z - 1.0) * rank_radio))
    U, s = randomized_symmetric_lowrank(X_avgd, rank_pad, draws)
    keep = (torch.arange(rank_pad, device=U.device) < rank_act)[None, :]
    X_half = torch.where(keep, U * torch.sqrt(s)[None, :], 0.0)
    return torch.where(op.mask[:, None], X_half, 0.0)


class _RowShardedMatrix:
    """A symmetric [n, n] matrix whose rows are split over a mesh axis:
    ``A @ M`` is this rank's rows times M, all-gathered (the matmul
    :func:`sig_sdp_mmw_torch.ops.rsvd.randomized_symmetric_lowrank`
    takes)."""

    def __init__(self, local: torch.Tensor, graph, n: int):
        self.local, self.graph = local, graph
        self.shape, self.dtype = (n, n), local.dtype

    def __matmul__(self, M: torch.Tensor) -> torch.Tensor:
        return self.graph.gather_rows(self.local @ M, self.shape[0])


@solve_span("mmw.solve")
def mmw_solve(state: SigState, Z, *, nit: int, eta: float,
              rank_radio: int = 2, D_pad: int, rank_pad: int, draws,
              lanczos_m: Optional[int] = None, log_gap: bool = False,
              gap_lanczos_m: int = 32, graph=None) -> MMWOutput:
    """Run the MMW dual/loss/primal loop for ``Z`` slots on the state's
    device.  ``draws``: the random draws (``sketch``, ``omega``, ``gap``).

    ``graph`` — the graph axis of a mesh
    (:class:`sig_sdp_mmw_torch.parallel.mesh.MeshAxis`): the rows of every
    [Kp, Kp] array of the solve (S̃, S̃ᵀ and the patterns of ``op``, the
    primal's off-diagonal, the F violations and weights, ``L_accu`` and the
    averaged primal) are split over its ranks (``graph.rows(Kp)``); each
    rank keeps only its rows.  Every product with them is the rank's rows
    followed by one all-gather, and the F block's max and sum are gathered
    per rank and combined in rank order.  The [Kp] vectors and the [Kp, D]
    sketch factor stay replicated, the same bits on every rank.  The
    ``state`` passed in is the caller's, whole.  None: one process."""
    from sig_sdp_mmw_torch.parallel.mesh import MeshAxis

    Kp, K = state.Kp, state.K
    dtype = state.S.dtype
    device = state.S.device
    Zh = float(Z)
    Zf = torch.tensor(Zh, dtype=dtype, device=device)
    op = build_mmw_operands(state, Zf)
    D_act = int(Zh * rank_radio)                 # active sketch columns
    if lanczos_m is None:
        lanczos_m = mmw_default_lanczos_m(eta, nit)
    graph = graph if graph is not None else MeshAxis()
    r0, r1 = graph.rows(Kp)
    rows = slice(r0, r1)

    def own(x):
        """This rank's rows of a [Kp, Kp] operand (a copy when sharded,
        so the whole one is freed)."""
        return x[rows].clone() if graph.size > 1 else x[rows]

    StT, asso_t = own(op.St.T), own(op.asso_ut.T)
    op = dataclasses.replace(op, St=own(op.St), asso_ut=own(op.asso_ut),
                             xpat=own(op.xpat))
    mD, mF, mH = op.mask, op.asso_ut, op.mask
    mF_sym = mF | asso_t          # F pairs in either orientation, by rows

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def softmax(eD, eF, eH):
        """(YD, YF, YFt, sum of YF, YH): the dual weights, with this
        rank's rows of the F weights and of their transpose.  ``eF`` holds
        the F violations of both orientations (X_offdi is symmetric), so a
        rank reads its rows of YFᵀ from its own rows; in one process YFᵀ is
        YF.T itself."""
        YD, YF, YH, M, den = _softmax_3(eD, eF, eH, mD, mF, mH, graph)
        YFt = (YF.T if graph.size == 1
               else torch.where(asso_t, torch.exp(eF - M), 0.0) / den)
        return YD, YF, YFt, graph.sum_over(torch.sum(YF)), YH

    def local_ub(Xa):
        """Largest violation of the averaged primal (rows held by this
        rank), over every rank."""
        dXa = torch.diagonal(Xa, r0)
        u = _max_violation(*_violations(dXa, Xa - _diag_rows(dXa, rows, Kp),
                                        op, Zf, K, rows), op, rows)
        return graph.max_over(u)

    n_loc = r1 - r0
    e_accu_D, e_accu_F, e_accu_H = zeros(Kp), zeros(n_loc, Kp), zeros(Kp)
    L_accu = zeros(n_loc, Kp)
    X_mdiag = torch.where(op.mask, 1.0, 0.0).to(dtype)     # X0 = I
    X_offdi = zeros(n_loc, Kp)
    X_avgd = zeros(n_loc, Kp)
    YaD, YaF, YaFt, YaH = zeros(Kp), zeros(n_loc, Kp), zeros(n_loc, Kp), \
        zeros(Kp)
    gap = zeros(nit if log_gap else 0, 2)
    # Initial Y: uniform over the valid constraints = softmax of zeros.
    YD, YF, YFt, sYF, YH = softmax(zeros(Kp), zeros(n_loc, Kp), zeros(Kp))

    for i in range(nit):
        # ---- averaging (pre-update) ---------------------------------------
        X_avgd = X_avgd + X_offdi + _diag_rows(X_mdiag[rows], rows, Kp)
        if log_gap:
            YaD, YaF, YaFt, YaH = (YaD + YD, YaF + YF, YaFt + YFt,
                                   YaH + YH)
            n = float(i + 1)
            L_avg = _loss_rows(YaD / n, YaF / n, YaFt / n,
                               graph.sum_over(torch.sum(YaF / n)),
                               YaH / n, op, StT, Zf, K, Kp, rows)
            lam_min, _ = lanczos_extreme_eigs(
                lambda V: graph.gather_rows(L_avg @ V, Kp),
                draws.gap(i, (Kp, 1), dtype), m=gap_lanczos_m)
            gap[i, 0] = local_ub(X_avgd / n)
            gap[i, 1] = lam_min * K

        # ---- dual step ----------------------------------------------------
        with span("mmw.dual"):
            eD, eF, eH = _violations(X_mdiag, X_offdi, op, Zf, K, rows)
            e_accu_D = e_accu_D + eta * eD
            e_accu_F = e_accu_F + eta * torch.where(mF_sym, eF, 0.0)
            e_accu_H = e_accu_H + eta * graph.gather_rows(eH, Kp)
            YD, YF, YFt, sYF, YH = softmax(e_accu_D, e_accu_F, e_accu_H)

        # ---- loss accumulation --------------------------------------------
        with span("mmw.loss"):
            L_accu = L_accu - eta * _loss_rows(YD, YF, YFt, sYF, YH, op, StT,
                                               Zf, K, Kp, rows)

        # ---- primal via sketched expm -------------------------------------
        with span("mmw.expm", lanczos=lanczos_route(device)):
            G = _sketch(draws, i, op, D_pad, D_act, dtype)
            X_half, _ = lanczos_expm_multiply(
                LanczosOperator(lambda V: graph.gather_rows(L_accu @ V, Kp),
                                0.5), G,
                m=lanczos_m, small_method="taylor_ss", norm_bound=eta * nit)
        with span("mmw.primal"):
            X_mdiag, X_offdi = _primal(op, X_half, K, rows)

    # ---- final averaged primal + factorization ----------------------------
    with span("mmw.factor"):
        X_avgd = X_avgd / nit
        ub_final = local_ub(X_avgd)
        X_half = _factor(_RowShardedMatrix(X_avgd, graph, Kp), op, Zh, K,
                         rank_radio, rank_pad, draws)
    return MMWOutput(X_half=X_half, ub_final=ub_final, gap_log=gap,
                     X_avgd=graph.gather_rows(X_avgd, Kp))


def make_mmw_phase_fns(*, nit: int, eta: float, rank_radio: int, D_pad: int,
                       lanczos_m: Optional[int] = None):
    """Per-phase step functions for profiled runs, bracketing the
    reference's phases (``mmw.py:124-197``: "mmw_dual", "mmw_loss",
    "mmw_expm").  :func:`mmw_solve` is the fast path; these trade its
    unbroken queue of launches for a synchronized time per phase."""
    if lanczos_m is None:
        lanczos_m = mmw_default_lanczos_m(eta, nit)

    def state_process(state: SigState, Z) -> MMWOperands:
        return build_mmw_operands(state, Z)

    def dual_step(op: MMWOperands, Z, X_mdiag, X_offdi, e_accu_D, e_accu_F,
                  e_accu_H):
        Zf = torch.as_tensor(Z, dtype=op.St.dtype, device=op.St.device)
        eD, eF, eH = _violations(X_mdiag, X_offdi, op, Zf, op.K)
        e_accu_D = e_accu_D + eta * eD
        e_accu_F = e_accu_F + eta * torch.where(op.asso_ut, eF, 0.0)
        e_accu_H = e_accu_H + eta * eH
        YD, YF, YH = _masked_softmax_3(e_accu_D, e_accu_F, e_accu_H,
                                       op.mask, op.asso_ut, op.mask)
        return e_accu_D, e_accu_F, e_accu_H, YD, YF, YH

    def loss_step(op: MMWOperands, Z, L_accu, YD, YF, YH):
        Zf = torch.as_tensor(Z, dtype=op.St.dtype, device=op.St.device)
        return L_accu - eta * _loss_matrix(YD, YF, YH, op, Zf, op.K,
                                           op.St.shape[-1])

    def expm_step(op: MMWOperands, Z, L_accu, draws, i: int):
        G = _sketch(draws, i, op, D_pad, int(float(Z) * rank_radio),
                    op.St.dtype)
        X_half, _ = lanczos_expm_multiply(
            LanczosOperator(lambda V: L_accu @ V, 0.5), G, m=lanczos_m,
            small_method="taylor_ss", norm_bound=eta * nit)
        return _primal(op, X_half, op.K)

    return state_process, dual_step, loss_step, expm_step


class MMW(StatsObject, SDPSolverBase):
    """Reference-compatible solver object (``mmw.py:12-24``) around
    :func:`mmw_solve`, pluggable into :class:`sig_sdp_mmw_torch.models.
    search.BinarySearchRelaxation`.  Call n of a solve draws from stream n
    of ``seed``."""

    def __init__(self, nit: int = 100, rank_radio: int = 2, alpha: float = 1.0,
                 eta: float = 0.1, log_gap: bool = False,
                 lanczos_m: Optional[int] = None, seed: int = 0):
        SDPSolverBase.__init__(self, nit=nit, rank_radio=rank_radio,
                               alpha=alpha)
        self.eta = eta
        self.LOG_GAP = log_gap
        self.lanczos_m = lanczos_m
        self.seed = seed
        self._ncall = 0
        # What the last solve ran as (:func:`solve_record`).
        self.last_solve = None

    def _draws(self, state: SigState) -> TorchDraws:
        self._ncall += 1
        return TorchDraws(self.seed, state.mask.device, stream=self._ncall)

    def _d_pad_for(self, state: SigState, Z: int) -> Tuple[int, int]:
        # Pad the sketch width to the binary search's upper bound, so every
        # probe has one shape; bucket to multiples of 16.
        _, ub = state.degree_bounds()
        zmax = max(int(Z), ub)
        D_pad = ((zmax * self.rank_radio + 15) // 16) * 16
        return D_pad, min(D_pad, state.Kp - 1)

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState,
                       D_pad: Optional[int] = None):
        tic = self._get_tic()
        if D_pad is None:
            D_pad, rank_pad = self._d_pad_for(state, Z)
        else:
            rank_pad = D_pad
        draws = self._draws(state)
        self.last_solve = solve_record(float(Z), state.K, D_pad, rank_pad,
                                       draws, self.nit)
        out = mmw_solve(state, float(Z), nit=self.nit, eta=self.eta,
                        rank_radio=self.rank_radio, D_pad=D_pad,
                        rank_pad=rank_pad, draws=draws,
                        lanczos_m=self.lanczos_m, log_gap=self.LOG_GAP,
                        record=self.last_solve)
        tim = self._get_tim(tic, sync=out.X_half)
        self._add_np_log("mmw_all_it", bs_iteration,
                         np.array([Z, state.K, tim]))
        if self.LOG_GAP:
            gap = out.gap_log.cpu().numpy()
            for i in range(gap.shape[0]):
                self._add_np_log("gap", i, np.array(
                    [gap[i, 0], gap[i, 1], gap[i, 0] - gap[i, 1]]))
        self.last_output = out
        return True, out.X_half

    def run_with_state_profiled(self, bs_iteration: int, Z: int,
                                state: SigState):
        """Profiled solve: per-phase wall times (CUDA-synchronized) under
        the reference's metric keys (mmw_state_process / mmw_dual /
        mmw_loss / mmw_expm / mmw_per_it / mmw_xavg / mmw_all_it).  The
        same arithmetic and draws as :func:`mmw_solve` at the same call
        count, minus the gap telemetry."""
        Kp, K = state.Kp, state.K
        D_pad, rank_pad = self._d_pad_for(state, Z)
        dtype, device = state.S.dtype, state.S.device
        state_process, dual_step, loss_step, expm_step = make_mmw_phase_fns(
            nit=self.nit, eta=self.eta, rank_radio=self.rank_radio,
            D_pad=D_pad, lanczos_m=self.lanczos_m)

        all_tic = self._get_tic()
        sp_tic = self._get_tic()
        op = state_process(state, torch.tensor(float(Z), dtype=dtype,
                                               device=device))
        self._add_np_log("mmw_state_process", 0, np.array(
            [Z, K, self._get_tim(sp_tic, sync=op.St)]))
        draws = self._draws(state)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        X_mdiag = torch.where(state.mask, 1.0, 0.0).to(dtype)
        X_offdi = zeros(Kp, Kp)
        eaD, eaF, eaH = zeros(Kp), zeros(Kp, Kp), zeros(Kp)
        L_accu = zeros(Kp, Kp)
        X_avgd = zeros(Kp, Kp)
        for i in range(self.nit):
            per_tic = self._get_tic()
            X_avgd = X_avgd + X_offdi + torch.diag(X_mdiag)

            tic = self._get_tic()
            eaD, eaF, eaH, YD, YF, YH = dual_step(op, float(Z), X_mdiag,
                                                  X_offdi, eaD, eaF, eaH)
            self._add_np_log("mmw_dual", i,
                             np.array([Z, K, self._get_tim(tic, sync=YH)]))

            tic = self._get_tic()
            L_accu = loss_step(op, float(Z), L_accu, YD, YF, YH)
            self._add_np_log("mmw_loss", i, np.array(
                [Z, K, self._get_tim(tic, sync=L_accu)]))

            tic = self._get_tic()
            X_mdiag, X_offdi = expm_step(op, float(Z), L_accu, draws, i)
            self._add_np_log("mmw_expm", i, np.array(
                [Z, K, self._get_tim(tic, sync=X_offdi)]))
            self._add_np_log("mmw_per_it", i,
                             np.array([Z, K, self._get_tim(per_tic)]))

        tic = self._get_tic()
        X_half = _factor(X_avgd / self.nit, op, float(Z), K, self.rank_radio,
                         rank_pad, draws)
        self._add_np_log("mmw_xavg", 0, np.array(
            [Z, K, self._get_tim(tic, sync=X_half)]))
        self._add_np_log("mmw_all_it", bs_iteration,
                         np.array([Z, K, self._get_tim(all_tic)]))
        return True, X_half
