"""Summarize a matched-Z oracle run (``sim_mmw_oracle_z``) into Markdown.

Port of ``tools/oracle_z_report.py``: from the ``scs-``, ``mmw150-`` and
``rand-<cell>-<tag>`` CSVs of one run directory (rows ``[g_it, seed, Z, rem,
per-user BLER...]``; a seed written twice keeps its last row) it computes,
over the seeds present in all three, the oracle's Z mean/std/min/max, the
oracle's, MMW's and rand's feasible shares at the oracle's Z, the count of
seeds where oracle and MMW are both feasible, and each method's mean BLER
and median max-BLER.  It also lists each seed's oracle Z and the seeds where
MMW or the oracle leaves a remainder.

The Markdown goes to ``--out`` (default ``<run_dir>/ORACLE_Z.md``) and the
statistics to ``oracle_z_report.json`` beside it; nothing is written
anywhere else.

    python -m sig_sdp_mmw_torch.experiments.oracle_z_report <run_dir> \\
        [--cell 10] [--tag 75] [--out report.md]
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np


def load(path: str, name: str) -> dict:
    """{seed: (Z, rem, per-user BLER)} of one metric file."""
    rows = []
    with open(os.path.join(path, name)) as f:
        for r in csv.reader(f):
            vals = [float(x) for x in r]
            rows.append((int(vals[1]), int(vals[2]), int(vals[3]),
                         np.asarray(vals[4:])))
    return {seed: (Z, rem, bler) for seed, Z, rem, bler in rows}


def stats(run_dir: str, cell: int = 10, tag: str = "75") -> dict:
    """The report's statistics over the seeds present in all three files."""
    runs = {m: load(run_dir, f"{f}-{cell}-{tag}")
            for m, f in (("oracle", "scs"), ("mmw", "mmw150"),
                         ("rand", "rand"))}
    seeds = sorted(set.intersection(*(set(d) for d in runs.values())))
    Z = np.asarray([runs["oracle"][s][0] for s in seeds])
    rem = {m: np.asarray([d[s][1] for s in seeds]) for m, d in runs.items()}
    out = {
        "cell": cell, "K": 3 * cell * cell, "n": len(seeds), "seeds": seeds,
        "Z": Z.tolist(),
        "Z_mean": float(Z.mean()), "Z_std": float(Z.std()),
        "Z_min": int(Z.min()), "Z_max": int(Z.max()),
        "agree": int(np.sum((rem["oracle"] == 0) & (rem["mmw"] == 0))),
    }
    for m, d in runs.items():
        out[f"{m}_feasible"] = float(np.mean(rem[m] == 0))
        out[f"{m}_infeasible_seeds"] = [s for s, r in zip(seeds, rem[m])
                                        if r != 0]
        out[f"{m}_bler_mean"] = float(np.mean(
            [d[s][2].mean() for s in seeds]))
        out[f"{m}_bler_max_median"] = float(np.median(
            [d[s][2].max() for s in seeds]))
    return out


def render(s: dict, run_dir: str) -> list:
    """The Markdown lines; the statistic lines read as the JAX tool's."""
    n = s["n"]
    return [
        "# Matched-Z oracle validation, PyTorch port "
        "(`sig_sdp_mmw_torch/experiments/sim_mmw_oracle_z.py`)",
        "",
        f"Per seed (cell={s['cell']}, K={s['K']}, rho=0.0075, {n} seeds), "
        "the exact SDP oracle (ADMM consensus, nit=500) drives the binary "
        "search to its min feasible Z; MMW (nit=150, eta=0.04) and the "
        "random baseline are then rounded at that same Z.",
        "",
        f"- Oracle Z: mean {s['Z_mean']:.2f} ± {s['Z_std']:.2f} "
        f"(min {s['Z_min']}, max {s['Z_max']})",
        f"- Oracle feasible (rem=0): {s['oracle_feasible']*100:.0f}%",
        f"- **MMW feasible at the oracle's Z: "
        f"{s['mmw_feasible']*100:.0f}%** "
        f"({s['agree']}/{n} seeds agree oracle-feasible AND MMW-feasible)",
        f"- rand feasible at the oracle's Z: {s['rand_feasible']*100:.0f}% "
        "(control: the Z is information-bearing, not trivially roundable)",
        "",
        "| method | mean BLER (avg over seeds) | median max-BLER |",
        "|---|---|---|",
        f"| oracle (ADMM) | {s['oracle_bler_mean']:.2e} | "
        f"{s['oracle_bler_max_median']:.2e} |",
        f"| MMW-150       | {s['mmw_bler_mean']:.2e} | "
        f"{s['mmw_bler_max_median']:.2e} |",
        f"| rand          | {s['rand_bler_mean']:.2e} | "
        f"{s['rand_bler_max_median']:.2e} |",
        "",
        "Seeds where MMW leaves a remainder at the oracle's Z (seed: Z): "
        + (", ".join(f"{sd}: {z}" for sd, z in zip(s["seeds"], s["Z"])
                     if sd in s["mmw_infeasible_seeds"]) or "none"),
        "",
        "Seeds where the oracle leaves a remainder: "
        + (", ".join(map(str, s["oracle_infeasible_seeds"])) or "none"),
        "",
        "Oracle Z per seed: "
        + ", ".join(f"{sd}: {z}" for sd, z in zip(s["seeds"], s["Z"])),
        "",
        f"Raw rows: `{run_dir}` "
        "(CSV: [g_it, seed, Z, rem, per-user BLER...]).",
    ]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("--cell", type=int, default=10)
    p.add_argument("--tag", type=str, default="75")
    p.add_argument("--out", type=str, default=None,
                   help="Markdown path (default <run_dir>/ORACLE_Z.md)")
    args = p.parse_args(argv)

    s = stats(args.run_dir, args.cell, args.tag)
    lines = render(s, args.run_dir)
    out = args.out or os.path.join(args.run_dir, "ORACLE_Z.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(os.path.dirname(os.path.abspath(out)),
                           "oracle_z_report.json"), "w") as f:
        json.dump(s, f, indent=1)
        f.write("\n")
    print("\n".join(lines))
    return s


if __name__ == "__main__":
    main()
