"""Render the paper-style figures from experiment output dirs.

Port of :mod:`sig_sdp_mmw_tpu.experiments.plot_results` (host numpy and
matplotlib with the ``Agg`` backend; the same figure files from the same
data).  Point it at the output dir of any sim script and it infers which
figures to draw from the metric-file names.

  python -m sig_sdp_mmw_torch.experiments.plot_results <data_dir> \\
      [--out pdfdir] [--sparsity]

Figures (reference counterparts in sim_script/journal_version + ton_major_rv):
  * ``mmw-<cell>-*`` etc.        -> avg/max BLER vs network size, BLER CDF
                                    (plot_data_bler_avg_max_*.py)
  * ``mmw-dual-*``               -> duality-gap UB/LB curves and the
                                    (eta x iteration) heatmap (plot_duality_gap)
  * ``conv-rho-* / conv-alp-*``  -> max-violation convergence (plot_convergence_*)
  * ``*-time-*``                 -> solve-time vs K (plot_data_mmw_scs_iter_time,
                                    plot_data_mmw_time)
  * ``online-*``                 -> online BLER vs staleness step
                                    (plot_data_bler_online*.py)
  * ``graph-*``                  -> K / Omega / C envelopes (plot_graph_test)
  * ``--sparsity``               -> constraint-pattern spy plots
                                    (plot_matrix_sparsity.py)
"""

from __future__ import annotations

import argparse
import collections
import csv
import os
import re
from typing import Dict, List

import numpy as np


def _read_metric_files(data_dir: str) -> Dict[str, List[List[float]]]:
    out = {}
    for name in sorted(os.listdir(data_dir)):
        p = os.path.join(data_dir, name)
        if not os.path.isfile(p):
            continue
        if name.endswith((".jsonl", ".pdf", ".png", ".txt")):
            continue
        rows = []
        try:
            with open(p) as f:
                for row in csv.reader(f):
                    if row:
                        rows.append([float(x) for x in row])
        except ValueError:
            continue  # not a metric CSV (ledger, figure, report, ...)
        out[name] = rows
    return out


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig():
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4), dpi=120)
    return plt, fig, ax


def _save(plt, fig, out_dir, fname):
    fig.savefig(os.path.join(out_dir, fname), bbox_inches="tight")
    plt.close(fig)


def plot_bler(data, out_dir):
    groups = collections.defaultdict(dict)   # method -> cell -> bler array
    for name, rows in data.items():
        m = re.match(r"(\w+)-(\d+)-(\d+)$", name)
        if not m or name.startswith(("online", "conv", "graph")):
            continue
        method, cell = m.group(1), int(m.group(2))
        blers = np.concatenate([np.asarray(r[3:]) for r in rows])
        groups[method][cell] = blers
    if not groups:
        return
    plt, fig, ax = _fig()
    for method, cells in sorted(groups.items()):
        xs = sorted(cells)
        ax.semilogy(xs, [cells[c].mean() for c in xs], "-o",
                    label=f"{method} avg")
        ax.semilogy(xs, [cells[c].max() for c in xs], "--x",
                    label=f"{method} max")
    ax.set_xlabel("cell size l (grid = l x l APs)")
    ax.set_ylabel("BLER")
    ax.legend(fontsize=7)
    ax.grid(True, which="both", alpha=0.3)
    _save(plt, fig, out_dir, "bler_avg_max.pdf")

    plt, fig, ax = _fig()
    for method, cells in sorted(groups.items()):
        allb = np.sort(np.concatenate(list(cells.values())))
        ax.semilogx(allb, np.linspace(0, 1, allb.size), label=method)
    ax.set_xlabel("per-user BLER")
    ax.set_ylabel("CDF")
    ax.legend(fontsize=8)
    ax.grid(True, which="both", alpha=0.3)
    _save(plt, fig, out_dir, "bler_cdf.pdf")


def plot_gap(data, out_dir, prefix="mmw-dual-", fname="duality_gap.pdf"):
    plt, fig, ax = _fig()
    drew = False
    for name, rows in sorted(data.items()):
        if not name.startswith(prefix):
            continue
        ubs = np.asarray([r[2:] for r in rows[0::2]])
        ax.plot(ubs.mean(axis=0), label=f"{name} UB")
        if len(rows) > 1:
            lbs = np.asarray([r[2:] for r in rows[1::2]])
            ax.plot(lbs.mean(axis=0), "--", label=f"{name} LB")
        drew = True
    if not drew:
        plt.close(fig)
        return
    ax.set_xlabel("iteration")
    ax.set_ylabel("duality gap telemetry")
    ax.legend(fontsize=6)
    ax.grid(True, alpha=0.3)
    _save(plt, fig, out_dir, fname)


def plot_gap_heatmap(data, out_dir, prefix="mmw-dual-",
                     fname="duality_gap_heatmap.pdf"):
    """(eta x iterations) heatmap of the normalized duality gap, one panel
    per cell size — the reference's ``plot_duality_gap.py`` figure
    (``sim_script/journal_version/plot_duality_gap.py:40-75``): metric rows
    come in (UB, LB) pairs per run, gap = (UB - LB) normalized to its first
    iteration, imshow with a log iteration axis."""
    groups = collections.defaultdict(dict)   # cell -> eta_pct -> gap[t]
    for name, rows in sorted(data.items()):
        # sim_all_mmw / gap_c15_sweep: mmw-dual-<cell>-<eta*100>
        m = re.match(re.escape(prefix) + r"(\d+)-(\d+)$", name)
        if not m or len(rows) < 2:
            continue
        cell, eta_idx = (int(g) for g in m.groups())
        ub = np.asarray(rows[0])[2:]
        lb = np.asarray(rows[1])[2:]
        gap = ub - lb
        if gap.size == 0 or gap[0] == 0:
            continue
        groups[cell][eta_idx] = gap / gap[0]
    if not groups:
        return
    cells = sorted(groups)
    plt = _pyplot()
    fig, axs = plt.subplots(1, len(cells), figsize=(3 * len(cells), 2.6),
                            squeeze=False)
    for a, cell in enumerate(cells):
        etas = sorted(groups[cell])
        T = max(g.size for g in groups[cell].values())
        img = np.full((len(etas), T), np.nan)
        for r, ei in enumerate(etas):
            g = groups[cell][ei]
            img[r, : g.size] = g
        ax = axs[0][a]
        im = ax.imshow(img, cmap="viridis", aspect="auto", vmin=0, vmax=1)
        ax.set_xscale("log")
        ax.set_xlim(1, max(T, 2))
        ax.set_yticks(range(len(etas)))
        ax.set_yticklabels([f"{ei / 100:.02f}" for ei in etas], fontsize=6)
        ax.set_xlabel("iterations")
        ax.set_title(f"cell {cell}", fontsize=8)
        if a == 0:
            ax.set_ylabel(r"$\eta$")
    fig.colorbar(im, ax=[axs[0][-1]], label="normalized gap")
    _save(plt, fig, out_dir, fname)


def plot_convergence(data, out_dir):
    for tag in ("conv-rho-", "conv-alp-"):
        plt, fig, ax = _fig()
        drew = False
        for name, rows in sorted(data.items()):
            if not name.startswith(tag):
                continue
            ub = np.asarray([r[2:] for r in rows]).mean(axis=0)
            ax.plot(ub, label=name)
            drew = True
        if not drew:
            plt.close(fig)
            continue
        ax.set_xlabel("MMW iteration")
        ax.set_ylabel("max constraint violation of averaged X")
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
        _save(plt, fig, out_dir, f"{tag.strip('-')}.pdf")


def plot_time(data, out_dir):
    series = collections.defaultdict(list)   # name -> (K, wall_us)
    for name, rows in data.items():
        m = re.match(r"(\w+)-time-(\d+)-(\d+)$", name)
        if not m:
            continue
        for r in rows:
            if len(r) >= 5:
                series[m.group(1)].append((r[2], r[4]))
    if not series:
        return
    plt, fig, ax = _fig()
    for name, pts in sorted(series.items()):
        pts = sorted(pts)
        ks = sorted({k for k, _ in pts})
        med = [np.median([t for k2, t in pts if k2 == k]) / 1e6 for k in ks]
        ax.plot(ks, med, "-o", label=name)
    ax.set_xlabel("users K")
    ax.set_ylabel("end-to-end solve time (s)")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    _save(plt, fig, out_dir, "solve_time_vs_K.pdf")


def plot_online(data, out_dir):
    curves = collections.defaultdict(dict)   # (method, nit) -> step -> mean bler
    for name, rows in data.items():
        m = re.match(r"online-(\w+)-(\d+)-(\d+)-(\d+)-(\d+)$", name)
        if not m:
            continue
        method, step, nit = m.group(1), int(m.group(2)), int(m.group(3))
        blers = np.concatenate([np.asarray(r[2:]) for r in rows])
        curves[(method, nit)][step] = blers.mean()
    if not curves:
        return
    plt, fig, ax = _fig()
    for (method, nit), steps in sorted(curves.items()):
        xs = sorted(steps)
        ax.semilogy(xs, [steps[s] for s in xs], "-o",
                    label=f"{method} (nit={nit})")
    ax.set_xlabel("staleness step")
    ax.set_ylabel("avg BLER")
    ax.legend(fontsize=7)
    ax.grid(True, which="both", alpha=0.3)
    _save(plt, fig, out_dir, "online_bler.pdf")


def plot_graph(data, out_dir):
    pts = collections.defaultdict(list)      # rho -> (cell, K, omega, C)
    for name, rows in data.items():
        m = re.match(r"graph-(\d+)-(\d+)$", name)
        if not m:
            continue
        cell, rho = int(m.group(1)), int(m.group(2))
        arr = np.asarray([r[2:] for r in rows]).mean(axis=0)
        pts[rho].append((cell, *arr[:3]))
    if not pts:
        return
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5), dpi=120)
    for rho, rowlist in sorted(pts.items()):
        rowlist = sorted(rowlist)
        cells = [r[0] for r in rowlist]
        for ax, idx, lab in zip(axes, (1, 2, 3), ("K", "Omega", "C")):
            ax.plot(cells, [r[idx] for r in rowlist], "-o",
                    label=f"rho={rho / 1e4}")
            ax.set_xlabel("cell size")
            ax.set_ylabel(lab)
            ax.grid(True, alpha=0.3)
    axes[0].legend(fontsize=7)
    _save(plt, fig, out_dir, "graph_stats.pdf")


def plot_matrix_sparsity(out_dir, cells=(5, 10, 15), rho=75e-4, seed=3):
    """Constraint-pattern spy plots — the analogue of the reference's
    ``journal_version/plot_matrix_sparsity.py`` (D = S + S^T + Q + Q^T after
    a reordering), extended with the orderings the block-sparse backend
    uses: rows = orderings (RCM as in the reference figure, raster grid
    order (``generate_large_state_csr(order="raster")``, i.e.
    ``ops.bcsr.spatial_order``), Hilbert curve order), columns = cell sizes.
    Each panel is annotated with the (8, 128)-block fill — the storage and
    traffic multiplier of :mod:`sig_sdp_mmw_torch.ops.bcsr`."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.ops.bcsr import hilbert_order

    def block_fill(M, Br=8, Bc=128):
        coo = M.tocoo()
        Kbc = -(-M.shape[0] // Bc)
        nblk = np.unique((coo.row // Br) * Kbc + coo.col // Bc).size
        return 100.0 * M.nnz / max(nblk * Br * Bc, 1)

    plt = _pyplot()
    orders = ("rcm", "raster", "hilbert")
    fig, axes = plt.subplots(len(orders), len(cells),
                             figsize=(3.2 * len(cells), 3.2 * len(orders)),
                             dpi=120, squeeze=False)
    for ci, cell in enumerate(cells):
        S, Q, _, locs = generate_large_state_csr(
            cell, rho, seed=seed, return_locs=True, order="raster")
        D = (S + S.T + Q + Q.T).tocsr()
        D.setdiag(0)
        D.eliminate_zeros()
        for oi, oname in enumerate(orders):
            if oname == "rcm":
                perm = reverse_cuthill_mckee(D, symmetric_mode=True)
            elif oname == "hilbert":
                perm = hilbert_order(locs)
            else:
                perm = np.arange(D.shape[0])
            Dp = D[perm][:, perm]
            r, c = Dp.nonzero()
            ax = axes[oi, ci]
            ax.scatter(r, c, s=max(0.02, 2.0 / cell), rasterized=True)
            ax.set_aspect("equal", "box")
            ax.invert_yaxis()
            ax.set_xticks([0, D.shape[0]])
            ax.set_yticks([0, D.shape[0]])
            ax.set_xticklabels([1, "$K$"])
            ax.set_yticklabels([1, "$K$"])
            ax.text(0.03, 0.03,
                    f"{oname}, $l$={cell * 20} m\n"
                    f"fill {block_fill(Dp):.1f}%",
                    transform=ax.transAxes, fontsize=8)
    fig.tight_layout()
    _save(plt, fig, out_dir, "matrix_sparsity.pdf")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sparsity", action="store_true",
                    help="also render the matrix-sparsity spy figure "
                         "(generates its own states; no data dir needed)")
    args = ap.parse_args(argv)
    out_dir = args.out or args.data_dir
    os.makedirs(out_dir, exist_ok=True)

    data = _read_metric_files(args.data_dir)
    plot_bler(data, out_dir)
    plot_gap(data, out_dir)
    plot_gap_heatmap(data, out_dir)
    plot_convergence(data, out_dir)
    plot_time(data, out_dir)
    plot_online(data, out_dir)
    plot_graph(data, out_dir)
    if args.sparsity:
        plot_matrix_sparsity(out_dir)
    print("figures written to", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
