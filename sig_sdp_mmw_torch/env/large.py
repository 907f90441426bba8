"""Large-scale scenario generation: sparse state without densification.

Port of :mod:`sig_sdp_mmw_tpu.env.large` — the same numpy/scipy host code
(and the same native/python backend rule), importing the port's own
``EnvParams``, ``hilbert_order`` and native builder.

The reference generator computes a dense [K, A] channel matrix
(``env.py:144-155``) — infeasible at the north-star scale (100k-1M links,
BASELINE.json configs 4-5).  This generator exploits what makes the state
sparse in the first place: thresholding at ``min_s_n_ratio`` (``env.py:151``)
implies a finite interference radius, so each user only interacts with APs
inside a computable cutoff.  A KD-tree neighbor query then builds the CSR
channel directly with O(K * deg) work and memory, and the state follows the
exact reference semantics (argmax association, S = rxpr[:, asso],
h_max = diag/min_sinr - 1; ``env.py:168-196``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import numpy as np

from sig_sdp_mmw_torch.env import phy
from sig_sdp_mmw_torch.env.env import EnvParams


def interference_cutoff_m(p: EnvParams, min_ratio: Optional[float] = None
                          ) -> float:
    """Distance beyond which a power-controlled user's rx ratio at any AP is
    below ``min_ratio`` (default: the state threshold ``min_s_n_ratio``) even
    for the worst in-cell own-AP distance."""
    # Own-AP distance is at most half the cell diagonal.
    d_own = p.cell_edge * math.sqrt(2.0) / 2.0
    ratio = p.min_s_n_ratio if min_ratio is None else min_ratio
    margin_db = 10.0 * math.log10(p.min_sinr * p.txp_offset / ratio)
    # loss(d) - loss(d_own) = 28 log10((d+1)/(d_own+1)) (env.py:93-97)
    return (d_own + 1.0) * 10.0 ** (margin_db / 28.0) - 1.0


def ap_grid(p: EnvParams) -> np.ndarray:
    """AP positions (host float64; ``env.py:52-56`` ordering)."""
    offset = p.cell_edge / 2.0
    x = np.linspace(offset, p.grid_edge - offset, p.cell_size)
    xx, yy = np.meshgrid(x, x)
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


def tail_margin_h(stas: np.ndarray, p: EnvParams, asso: np.ndarray,
                  Z_est: int, cutoff: Optional[float] = None) -> np.ndarray:
    """Expected SUB-THRESHOLD interference per user, for folding into h_max.

    The state thresholds rx ratios below ``min_s_n_ratio`` to zero
    (``env.py:151``), so the solver's budget ignores the aggregate of many
    tiny far-user contributions; at 100k+ links that aggregate pushes
    ~5-10% of users past the 1e-5 BLER design target (BLER_TAIL_SWEEP.json)
    even on solver-feasible assignments.  This returns the mean-field
    expectation of that omitted load — (sum of linear user powers / Z_est)
    x the per-AP geometric tail factor already used by the sparse
    evaluator (:func:`_tail_factors_per_ap`) — which the caller SUBTRACTS
    from ``h_max`` at generation time so the solved schedule carries the
    right safety margin (``Z_est``: the expected slot count, e.g. the
    degree lower bound + a few).
    """
    aps = ap_grid(p)
    R = cutoff if cutoff is not None else interference_cutoff_m(p)
    T = _linear_channel_factors(stas, aps, p)
    c_tail = _tail_factors_per_ap(aps, p, R)
    return (T.sum() / max(Z_est, 1)) * c_tail[asso]


def generate_large_state_csr(cell_size: int, sta_density_per_1m2: float = 75e-4,
                             seed: int = 0, params: Optional[EnvParams] = None,
                             return_locs: bool = False, backend: str = "auto",
                             order: str = "hilbert",
                             tail_margin_z: Optional[int] = None):
    """(S_csr, Q_csr, h_max[, sta_locs]) for a cell_size^2-AP grid at any
    scale.  Users are relabeled in spatial order so the interference graph
    is block-sparse friendly (:mod:`sig_sdp_mmw_torch.ops.bcsr`); a pure
    relabeling, solution-invariant.  ``order``: ``"hilbert"`` (default —
    space-filling-curve locality, 1.75x the block fill of the raster order)
    or ``"raster"`` (legacy row-major grid-cell sort).

    ``tail_margin_z``: when set, subtract the expected sub-threshold
    interference at that slot count from every user's budget
    (:func:`tail_margin_h`) — the BLER-tail mitigation: the solver then
    schedules against the honest total-interference budget instead of the
    thresholded one.  Budgets are floored at 10% of their raw value so a
    pessimistic margin can tighten but never erase a user's budget.

    ``backend``: ``"native"`` = the multithreaded C++ builder
    (csrc/sig_native.cpp), ``"python"`` = this module's scipy path,
    ``"auto"`` = native when buildable AND the instance is large enough to
    benefit (the vectorized scipy path wins below ~30k links; the threaded
    native builder wins ~2x above), else python.  Both produce the same
    state (tests/test_native.py pins pattern-exact agreement).
    """
    import scipy.sparse
    from scipy.spatial import cKDTree

    p = params or EnvParams(cell_size=cell_size,
                            sta_density_per_1m2=sta_density_per_1m2)
    rng = np.random.default_rng(seed)
    K, A = p.n_sta, p.n_ap

    aps = ap_grid(p)
    stas = rng.uniform(0.0, p.grid_edge, size=(K, 2))
    from sig_sdp_mmw_torch.ops.bcsr import hilbert_order, spatial_order

    if order == "hilbert":
        stas = stas[hilbert_order(stas)]
    elif order == "raster":
        stas = stas[spatial_order(stas, p.cell_edge)]
    else:
        raise ValueError(f"order must be 'hilbert' or 'raster', got {order!r}")

    cutoff = interference_cutoff_m(p)

    _NATIVE_MIN_K = 30_000  # measured crossover vs the scipy path
    if backend == "native" or (backend == "auto" and K >= _NATIVE_MIN_K):
        from sig_sdp_mmw_torch import native
        if native.native_available():
            S, Q, h_max, _asso = native.build_state_csr_native(stas, p, cutoff)
            if tail_margin_z:
                h_max = np.maximum(
                    h_max - tail_margin_h(stas, p, _asso, tail_margin_z,
                                          cutoff), 0.1 * h_max)
            if return_locs:
                return S, Q, h_max, stas
            return S, Q, h_max
        if backend == "native":
            raise RuntimeError("native builder requested but unavailable")
    tree = cKDTree(aps)
    pairs = tree.query_ball_point(stas, r=cutoff)

    rows = np.concatenate([np.full(len(nb), k) for k, nb in enumerate(pairs)])
    cols = np.concatenate([np.asarray(nb, dtype=np.int64) for nb in pairs])
    dis = np.linalg.norm(stas[rows] - aps[cols], axis=1)

    loss_db = (20.0 * math.log10(p.fre_Hz / 1e6) + 16.0 - 28.0
               + 28.0 * np.log10(dis + 1.0))
    gain = -loss_db
    # Power control to the strongest AP (env.py:136-142).
    gmax = np.full(K, -np.inf)
    np.maximum.at(gmax, rows, gain)
    noise = phy.noise_dbm(p.bandwidth)
    txp = (p.min_sinr_db - (gmax - noise)
           + 10.0 * math.log10(p.txp_offset))            # [K]
    rxpr_db = txp[rows] - loss_db - noise
    rxpr = 10.0 ** (rxpr_db / 10.0)
    keep = rxpr >= p.min_s_n_ratio
    rows, cols, rxpr = rows[keep], cols[keep], rxpr[keep]

    R = scipy.sparse.csr_matrix((rxpr, (rows, cols)), shape=(K, A))

    # Association by argmax over each user's neighborhood (env.py:177): per
    # user, the first column (in query order) achieving the max.
    best = np.full(K, -np.inf)
    np.maximum.at(best, rows, rxpr)
    is_best = rxpr >= best[rows]
    for_r = rows[is_best]
    for_c = cols[is_best]
    order = np.argsort(for_r, kind="stable")
    for_r, for_c = for_r[order], for_c[order]
    firsts = np.searchsorted(for_r, np.arange(K), side="left")
    asso = for_c[np.minimum(firsts, for_c.size - 1)]

    S = R[:, asso].tocsr()
    S.eliminate_zeros()
    S.sort_indices()

    # Association cliques (env.py:182-190).
    order = np.argsort(asso, kind="stable")
    sorted_asso = asso[order]
    qi, qj = [], []
    start = 0
    for a_end in np.flatnonzero(np.diff(sorted_asso)).tolist() + [K - 1]:
        group = order[start:a_end + 1]
        start = a_end + 1
        g = np.asarray(group)
        if g.size > 1:
            ii, jj = np.meshgrid(g, g)
            m = ii != jj
            qi.append(ii[m])
            qj.append(jj[m])
    if qi:
        qi = np.concatenate(qi)
        qj = np.concatenate(qj)
    else:
        qi = np.zeros(0, np.int64)
        qj = np.zeros(0, np.int64)
    Q = scipy.sparse.csr_matrix((np.ones(qi.size), (qi, qj)), shape=(K, K))

    h_max = np.asarray(S.diagonal()).ravel() / p.min_sinr - 1.0
    if tail_margin_z:
        h_max = np.maximum(
            h_max - tail_margin_h(stas, p, asso, tail_margin_z, cutoff),
            0.1 * h_max)
    if return_locs:
        return S, Q, h_max, stas
    return S, Q, h_max


# ---------------------------------------------------------------------------
# Sparse evaluation (reference env.py:198-232 at scales where the dense
# [K, K] real channel cannot exist)
# ---------------------------------------------------------------------------

def _linear_channel_factors(stas: np.ndarray, aps: np.ndarray, p: EnvParams):
    """Per-user linear factor T_k with rx_ratio(k, a) = T_k * (d_ka + 1)^-2.8
    under the reference's power control (env.py:93-97, 136-142)."""
    from scipy.spatial import cKDTree

    d_min, _ = cKDTree(aps).query(stas)
    L0 = 20.0 * math.log10(p.fre_Hz / 1e6) + 16.0 - 28.0
    gmax_db = -(L0 + 28.0 * np.log10(d_min + 1.0))
    noise = phy.noise_dbm(p.bandwidth)
    txp = (p.min_sinr_db - (gmax_db - noise)
           + 10.0 * math.log10(p.txp_offset))
    return 10.0 ** ((txp - noise - L0) / 10.0)


def _tail_factors_per_ap(aps: np.ndarray, p: EnvParams, R: float,
                         nq: int = 64) -> np.ndarray:
    """Mean-field geometric factor per AP: C_a = (1/area) * integral of
    (d+1)^-2.8 over the part of the grid farther than R from AP a.  A
    midpoint quadrature over the *finite* grid (an annulus integral would
    overcount: near the boundary most of the annulus lies outside the
    deployment area).  Multiplied by the summed linear power of a slot's
    users, this is the expected per-AP interference from users beyond the
    exact-evaluation radius under a uniform user distribution."""
    g = p.grid_edge
    q = (np.arange(nq) + 0.5) * g / nq
    qx, qy = np.meshgrid(q, q)
    qpts = np.stack([qx.ravel(), qy.ravel()], axis=1)      # [nq*nq, 2]
    out = np.zeros(aps.shape[0])
    chunk = max(1, int(2e7 // qpts.shape[0]))
    for s in range(0, aps.shape[0], chunk):
        d = np.linalg.norm(aps[s:s + chunk, None, :] - qpts[None, :, :],
                           axis=-1)
        out[s:s + chunk] = np.sum(
            np.where(d > R, (d + 1.0) ** -2.8, 0.0), axis=1)
    return out / (nq * nq)


@dataclasses.dataclass(frozen=True)
class SparseEvalGeometry:
    """What :func:`evaluate_sinr_sparse` needs of a deployment that does
    not depend on the assignment: the users' linear channel factors ``T``,
    the AP KD-tree, each user's association and own signal.  Built by
    :func:`sparse_eval_geometry` from the users and APs it describes."""
    stas: np.ndarray
    tree: object
    T: np.ndarray
    asso: np.ndarray
    signal: np.ndarray


def sparse_eval_geometry(stas: np.ndarray, aps: np.ndarray,
                         p: EnvParams) -> SparseEvalGeometry:
    from scipy.spatial import cKDTree

    T = _linear_channel_factors(stas, aps, p)
    tree = cKDTree(aps)
    d_own, asso = tree.query(stas)
    return SparseEvalGeometry(stas=stas, tree=tree, T=T, asso=asso,
                              signal=T * (d_own + 1.0) ** -2.8)


def evaluate_sinr_sparse(stas: np.ndarray, aps: np.ndarray, p: EnvParams,
                         z, Z: int, eval_min_ratio: float = 1e-3,
                         tail_correction: bool = True,
                         geometry: Optional[SparseEvalGeometry] = None,
                         c_tail: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-user SINR of assignment ``z`` — reference semantics
    (``env.py:198-224``: unthresholded channel, same-slot interference at the
    user's own AP, per-(AP, slot) winner rule) computed in O(K * deg_eval)
    instead of O(K^2):

    * exact contributions from every same-slot user whose rx ratio exceeds
      ``eval_min_ratio`` (a KD-tree ball query at the corresponding radius);
    * the omitted far tail replaced by its mean-field expectation (uniform
      user density x the analytic annulus integral of the path-loss law),
      added per slot — each omitted term is < eval_min_ratio and the
      correction keeps the *aggregate* unbiased, so the approximation error
      is O(sqrt(n_far)) fluctuations around an exact mean rather than a bias.
      ``tests/test_large_eval.py`` pins agreement with the dense evaluator.

    ``geometry`` (:func:`sparse_eval_geometry` of these ``stas``) and
    ``c_tail`` (``_tail_factors_per_ap`` at this ``eval_min_ratio``'s
    radius) let a caller that evaluates one deployment many times compute
    them once; they are computed here when not given.
    """
    K = stas.shape[0]
    A = aps.shape[0]
    z = np.asarray(z).astype(np.int64)
    if geometry is None:
        geometry = sparse_eval_geometry(stas, aps, p)
    elif geometry.stas is not stas:
        raise ValueError("geometry was built for other users")
    tree, T, asso, signal = (geometry.tree, geometry.T, geometry.asso,
                             geometry.signal)

    R_eval = interference_cutoff_m(p, min_ratio=eval_min_ratio)
    if not tail_correction:
        c_tail = np.zeros(A)
    elif c_tail is None:
        c_tail = _tail_factors_per_ap(aps, p, R_eval)

    interference = np.zeros(K)
    valid = (z >= 0) & (z < Z)
    for zz in range(Z):
        U = np.flatnonzero(valid & (z == zz))
        if U.size == 0:
            continue
        load = np.zeros(A)
        # Chunk the ball queries so peak memory stays O(chunk * deg_eval).
        chunk = max(1, int(4e6 / max(1.0, np.pi * R_eval ** 2
                                     / p.cell_edge ** 2)))
        for s in range(0, U.size, chunk):
            Uc = U[s:s + chunk]
            nb = tree.query_ball_point(stas[Uc], r=R_eval)
            lens = np.fromiter(map(len, nb), np.int64, count=len(nb))
            rows = np.repeat(np.arange(len(nb)), lens)
            cols = np.fromiter(itertools.chain.from_iterable(nb), np.int64,
                               count=int(lens.sum()))
            # The 2-norm of each (user, AP) difference, summed as
            # np.linalg.norm sums it.
            dx = stas[Uc, 0][rows] - aps[cols, 0]
            dy = stas[Uc, 1][rows] - aps[cols, 1]
            d = np.sqrt(dx * dx + dy * dy)
            np.add.at(load, cols, T[Uc][rows] * (d + 1.0) ** -2.8)
        tail = T[U].sum() * c_tail[asso[U]]
        # Own contribution (the k = j diagonal term, excluded by the
        # reference's S_gain_T_no_diag) is exactly `signal` for slot members.
        interference[U] = load[asso[U]] + tail - signal[U]

    sinr = np.full(K, 1e-3)
    sinr[valid] = signal[valid] / (np.maximum(interference[valid], 0.0) + 1.0)

    # Winner rule: within each (AP, slot) group only the strongest-SINR user
    # keeps its SINR (ties -> lowest index, matching np.ma.argmax).
    key = asso.astype(np.int64) * (Z + 1) + z
    key[~valid] = -1
    order = np.lexsort((np.arange(K), -sinr, key))
    ks = key[order]
    first = np.ones(K, bool)
    first[1:] = ks[1:] != ks[:-1]
    losers = order[~first & (ks >= 0)]
    sinr[losers] = 1e-3
    return sinr


class LargeEnv:
    """Large-scale environment: sparse state generation + sparse evaluation.

    The sparse counterpart of the dense ``WirelessEnv``
    (reference ``sim_src/env/env.py:5``) for the 100k-1M-link configs where
    the dense [K, A] / [K, K] channel matrices cannot be materialized.
    """

    def __init__(self, cell_size: int, sta_density_per_1m2: float = 75e-4,
                 seed: int = 0, params: Optional[EnvParams] = None,
                 backend: str = "auto", order: str = "hilbert",
                 tail_margin_z: Optional[int] = None):
        self.params = params or EnvParams(
            cell_size=cell_size, sta_density_per_1m2=sta_density_per_1m2)
        self.seed = seed
        self.backend = backend
        self.order = order
        self.tail_margin_z = tail_margin_z
        self._state = None
        self._stas = None
        # The z-independent parts of the evaluator, from this deployment's
        # own users and APs: its geometry and the tail factors per radius.
        self._eval_geometry = None
        self._tail = {}

    @property
    def K(self) -> int:
        return self.params.n_sta

    def generate_state_csr(self):
        """(S_csr, Q_csr, h_max) — cached per instance."""
        if self._state is None:
            S, Q, h, stas = generate_large_state_csr(
                self.params.cell_size, self.params.sta_density_per_1m2,
                seed=self.seed, params=self.params, return_locs=True,
                backend=self.backend, order=self.order,
                tail_margin_z=self.tail_margin_z)
            self._state = (S, Q, h)
            self._stas = stas
        return self._state

    def generate_ell(self, **kw):
        from sig_sdp_mmw_torch.core.ell import ell_from_scipy
        return ell_from_scipy(*self.generate_state_csr(), **kw)

    @property
    def sta_locs(self) -> np.ndarray:
        self.generate_state_csr()
        return self._stas

    def evaluate_sinr(self, z, Z: int, eval_min_ratio: float = 1e-3,
                      tail_correction: bool = True) -> np.ndarray:
        p, stas, aps = self.params, self.sta_locs, ap_grid(self.params)
        if self._eval_geometry is None:
            self._eval_geometry = sparse_eval_geometry(stas, aps, p)
        c_tail = None
        if tail_correction:
            R = interference_cutoff_m(p, min_ratio=eval_min_ratio)
            if R not in self._tail:
                self._tail[R] = _tail_factors_per_ap(aps, p, R)
            c_tail = self._tail[R]
        return evaluate_sinr_sparse(stas, aps, p, z, Z,
                                    eval_min_ratio=eval_min_ratio,
                                    tail_correction=tail_correction,
                                    geometry=self._eval_geometry,
                                    c_tail=c_tail)

    def evaluate_bler(self, z, Z: int, **kw) -> np.ndarray:
        p = self.params
        sinr = self.evaluate_sinr(z, Z, **kw)
        return phy.polyanskiy_model(sinr, p.packet_bit, p.bandwidth,
                                    p.slot_time).numpy()
