"""The plain reference's state model, in NumPy and SciPy.

A frozen copy of the reference scheduler's physical layer
(zhouyou-gu/sig-sdp-mmw ``sim_src/env/env.py``): a grid of access points,
users under power control towards their strongest AP, a log-distance path
loss, the Polyanskiy finite-blocklength BLER and the minimum SINR found by
bisection.  From it:

* :func:`dense_state` derives the journal's dense state ``(S, Q, h_max)``
  of given users, in float64;
* :func:`large_state` generates the large-scale sparse state of a seed
  (the reference repo's ``tools/e2e_large.py`` generator, Hilbert
  relabelling included), in float64 CSR.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

NOISE_FLOOR_DBM = -94.0


@dataclasses.dataclass(frozen=True)
class Params:
    """Scenario constants (the reference environment's arguments)."""

    cell_size: int
    sta_density_per_1m2: float
    cell_edge: float = 20.0
    fre_Hz: float = 4e9
    txp_offset: float = 2.0
    min_s_n_ratio: float = 0.1
    packet_bit: float = 800.0
    bandwidth: float = 5e6
    slot_time: float = 1.25e-4
    max_err: float = 1e-5

    @property
    def grid_edge(self) -> float:
        return self.cell_edge * self.cell_size

    @property
    def n_ap(self) -> int:
        return int(self.cell_size ** 2)

    @property
    def n_sta(self) -> int:
        return int(self.cell_size ** 2
                   * (self.sta_density_per_1m2 * self.cell_edge ** 2))

    @property
    def min_sinr_db(self) -> float:
        return min_sinr_db(self.packet_bit, self.bandwidth, self.slot_time,
                           self.max_err)

    @property
    def min_sinr(self) -> float:
        return 10.0 ** (self.min_sinr_db / 10.0)


def params_of(config: dict) -> Params:
    """The scenario of a configuration file's ``scenario`` group."""
    s = config["scenario"]
    return Params(cell_size=int(s["cell_size"]),
                  sta_density_per_1m2=float(s["sta_density_per_1m2"]))


def _bler(snr_dec: float, L_bits: float, B_hz: float, T_s: float) -> float:
    nu = -L_bits * math.log(2.0) + B_hz * T_s * math.log(1.0 + snr_dec)
    do = math.sqrt(B_hz * T_s * (1.0 - 1.0 / ((1.0 + snr_dec) ** 2)))
    return 0.5 * math.erfc((nu / do) / math.sqrt(2.0))


def min_sinr_db(L_bits: float, B_hz: float, T_s: float, max_err: float,
                a: float = -5.0, b: float = 30.0, tol: float = 0.1) -> float:
    """Minimum SINR (dB) whose BLER equals ``max_err``: the reference's
    bisection, to its tolerance."""
    def err(x_db):
        return _bler(10.0 ** (x_db / 10.0), L_bits, B_hz, T_s) / max_err - 1.0

    while err(a) - err(b) > tol:
        mid = (a + b) / 2.0
        e_mid = err(mid)
        if e_mid == 0:
            return mid
        if err(a) * e_mid < 0:
            b = mid
        else:
            a = mid
    return (a + b) / 2.0


def ap_grid(p: Params) -> np.ndarray:
    """AP positions; AP a = i*cell_size + j sits at (x[j], y[i])."""
    offset = p.cell_edge / 2.0
    x = np.linspace(offset, p.grid_edge - offset, p.cell_size)
    xx, yy = np.meshgrid(x, x)
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


def _loss_db(p: Params, dis):
    return (20.0 * math.log10(p.fre_Hz / 1e6) + 16.0 - 28.0
            + 28.0 * np.log10(dis + 1.0))


def rxpr_dense(p: Params, locs: np.ndarray) -> np.ndarray:
    """[K, A] received-power-to-noise ratios, unthresholded, float64."""
    aps = ap_grid(p)
    dis = np.linalg.norm(locs[:, None, :] - aps[None, :, :], axis=-1)
    loss = _loss_db(p, dis)
    smax = np.max(-loss, axis=1)
    txp = (p.min_sinr_db - (smax - NOISE_FLOOR_DBM)
           + 10.0 * math.log10(p.txp_offset))[:, None]
    return 10.0 ** ((txp - loss - NOISE_FLOOR_DBM) / 10.0)


def dense_state(p: Params, locs: np.ndarray):
    """(S, Q, h_max, S_raw) of users at ``locs`` [K, 2]: S[k, j] is user k's
    thresholded received ratio at the AP of user j, Q the association
    cliques, h_max each user's interference budget; ``S_raw`` is S before
    the threshold, for judging entries that lie on it."""
    raw = rxpr_dense(p, np.asarray(locs, np.float64))
    rx = np.where(raw < p.min_s_n_ratio, 0.0, raw)
    asso = np.argmax(rx, axis=1)
    S = rx[:, asso]
    K = S.shape[0]
    Q = (asso[:, None] == asso[None, :]).astype(np.float64)
    np.fill_diagonal(Q, 0.0)
    h_max = np.diagonal(S) / p.min_sinr - 1.0
    return S, Q, h_max, raw[:, asso]


def hilbert_order(locs: np.ndarray, order: int = 16) -> np.ndarray:
    """Permutation sorting users along a Hilbert curve (a relabelling)."""
    n = 1 << order
    xy = np.asarray(locs, np.float64)
    ext = float((xy.max(axis=0) - xy.min(axis=0)).max())
    q = ((xy - xy.min(axis=0)) / max(ext, 1e-9) * (n - 1)).astype(np.int64)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(x.shape[0], np.int64)
    s = n // 2
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        flip = ry == 0
        xr = np.where(flip & (rx == 1), n - 1 - x, x)
        yr = np.where(flip & (rx == 1), n - 1 - y, y)
        x, y = np.where(flip, yr, xr), np.where(flip, xr, yr)
        s //= 2
    return np.argsort(d, kind="stable")


def interference_cutoff_m(p: Params) -> float:
    """Distance beyond which a power-controlled user's ratio at any AP is
    below the threshold, even for the worst in-cell own-AP distance."""
    d_own = p.cell_edge * math.sqrt(2.0) / 2.0
    margin_db = 10.0 * math.log10(p.min_sinr * p.txp_offset
                                  / p.min_s_n_ratio)
    return (d_own + 1.0) * 10.0 ** (margin_db / 28.0) - 1.0


def large_state(p: Params, seed: int):
    """(S, Q, h_max) CSR float64 of ``p.n_sta`` users drawn uniformly from
    ``seed`` and relabelled along a Hilbert curve; S and Q as
    :func:`dense_state` has them, built from a KD-tree neighbour query so
    that no [K, A] matrix is formed."""
    import scipy.sparse
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    K = p.n_sta
    aps = ap_grid(p)
    stas = rng.uniform(0.0, p.grid_edge, size=(K, 2))
    stas = stas[hilbert_order(stas)]

    pairs = cKDTree(aps).query_ball_point(stas, r=interference_cutoff_m(p))
    lens = np.fromiter(map(len, pairs), np.int64, count=K)
    rows = np.repeat(np.arange(K), lens)
    cols = np.concatenate([np.asarray(nb, np.int64) for nb in pairs])
    dis = np.linalg.norm(stas[rows] - aps[cols], axis=1)
    loss = _loss_db(p, dis)
    gmax = np.full(K, -np.inf)
    np.maximum.at(gmax, rows, -loss)
    txp = (p.min_sinr_db - (gmax - NOISE_FLOOR_DBM)
           + 10.0 * math.log10(p.txp_offset))
    rxpr = 10.0 ** ((txp[rows] - loss - NOISE_FLOOR_DBM) / 10.0)
    keep = rxpr >= p.min_s_n_ratio
    rows, cols, rxpr = rows[keep], cols[keep], rxpr[keep]
    R = scipy.sparse.csr_matrix((rxpr, (rows, cols)), shape=(K, p.n_ap))

    # Association: per user, the first AP in query order with the largest
    # ratio.
    best = np.full(K, -np.inf)
    np.maximum.at(best, rows, rxpr)
    is_best = rxpr >= best[rows]
    fr, fc = rows[is_best], cols[is_best]
    o = np.argsort(fr, kind="stable")
    fr, fc = fr[o], fc[o]
    asso = fc[np.minimum(np.searchsorted(fr, np.arange(K)), fc.size - 1)]

    S = R[:, asso].tocsr()
    S.eliminate_zeros()
    S.sort_indices()

    # Association cliques: every ordered pair of distinct users of one AP.
    o = np.argsort(asso, kind="stable")
    counts = np.bincount(asso, minlength=p.n_ap)
    starts = np.concatenate([[0], np.cumsum(counts)])
    grp = np.repeat(np.arange(p.n_ap), counts)          # AP of o[t]
    pos = np.arange(K) - starts[grp]                    # rank inside it
    sz = counts[grp]
    ii = np.repeat(o, sz)
    jj_pos = np.concatenate([np.arange(n) for n in sz]) if K else sz
    jj = o[np.repeat(starts[grp], sz) + jj_pos]
    keep = np.repeat(pos, sz) != jj_pos
    Q = scipy.sparse.csr_matrix(
        (np.ones(int(keep.sum())), (ii[keep], jj[keep])), shape=(K, K))
    Q.sort_indices()

    h_max = np.asarray(S.diagonal()).ravel() / p.min_sinr - 1.0
    return S, Q, h_max
