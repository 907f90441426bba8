"""The matched-Z oracle study's runs side by side, seed for seed.

Reads the ``scs-``, ``mmw150-`` and ``rand-<cell>-<tag>`` CSVs of several
runs of ``sim_mmw_oracle_z`` on the same users (the JAX record
``oracle_z_run/``, the JAX package's study on another platform, the port
with ``--geometry``); a run may be split over several directories (one per
process).  For every seed present in all runs it lists each run's oracle Z
and MMW's and rand's remainders at that Z, then the paired differences of
the oracle's Z between runs (mean, spread, seeds that differ) and each
run's feasible shares on those seeds.  Nothing is solved here.

The table goes to ``--out`` (Markdown) with the statistics as JSON beside
it; nothing is written anywhere else.  Run from the repository's root; it
wrote ``port_studies/oracle_z_pair.md`` and ``.json``.

    python -m port_studies.oracle_z_pair \\
        --run record=oracle_z_run --run jax_cpu=A,B --run port=C,D \\
        --out pair.md
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from sig_sdp_mmw_torch.experiments.oracle_z_report import load

METRICS = (("oracle", "scs"), ("mmw", "mmw150"), ("rand", "rand"))


def load_run(dirs, cell: int = 10, tag: str = "75") -> dict:
    """{seed: {"Z", "oracle", "mmw", "rand"}} (remainders) over the
    directories of one run; a seed in several keeps its last row."""
    out = {}
    for d in dirs:
        files = {m: load(d, f"{f}-{cell}-{tag}") for m, f in METRICS}
        for seed in set.intersection(*(set(v) for v in files.values())):
            out[seed] = {"Z": files["oracle"][seed][0],
                         **{m: files[m][seed][1] for m in files}}
    return out


def pair(runs: dict) -> dict:
    """Per-seed rows and paired statistics of ``runs`` ({name: load_run})."""
    names = list(runs)
    seeds = sorted(set.intersection(*(set(r) for r in runs.values())))
    rows = [{"seed": s, **{n: runs[n][s] for n in names}} for s in seeds]
    stats = {"n": len(seeds), "seeds": seeds, "runs": {}, "diff": {}}
    for n in names:
        Z = np.array([runs[n][s]["Z"] for s in seeds])
        stats["runs"][n] = {
            "Z_mean": float(Z.mean()), "Z_std": float(Z.std()),
            **{f"{m}_feasible": int(sum(runs[n][s][m] == 0 for s in seeds))
               for m, _ in METRICS}}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = np.array([runs[b][s]["Z"] - runs[a][s]["Z"] for s in seeds])
            stats["diff"][f"{b}-{a}"] = {
                "mean": float(d.mean()), "std": float(d.std()),
                "higher": int((d > 0).sum()), "lower": int((d < 0).sum()),
                "seeds_differ": [s for s, x in zip(seeds, d) if x]}
    return {"rows": rows, "stats": stats}


def compact(p: dict, width: int = 10) -> list:
    """The oracle's Z and MMW's remainder, ``width`` seeds a row: each cell
    holds the runs in order, separated by " / ", seed by seed (the
    remainders as digits, 9 or less; a larger one in brackets)."""
    names = list(p["stats"]["runs"])

    def digit(x):
        return str(x) if x < 10 else f"[{x}]"

    lines = ["| seeds | Z: " + " / ".join(names) + " | MMW rem: "
             + " / ".join(names) + " |", "|---|---|---|"]
    rows = p["rows"]
    for i in range(0, len(rows), width):
        blk = rows[i:i + width]
        z = " / ".join(" ".join(str(r[n]["Z"]) for r in blk) for n in names)
        m = " / ".join("".join(digit(r[n]["mmw"]) for r in blk)
                       for n in names)
        lines.append(f"| {blk[0]['seed']}–{blk[-1]['seed']} | {z} | {m} |")
    return lines


def render(p: dict) -> list:
    names = list(p["stats"]["runs"])
    head = "| seed | " + " | ".join(
        f"{n} Z | {n} MMW rem | {n} rand rem" for n in names) + " |"
    lines = [head, "|" + "---|" * (1 + 3 * len(names))]
    for r in p["rows"]:
        lines.append(f"| {r['seed']} | " + " | ".join(
            f"{r[n]['Z']} | {r[n]['mmw']} | {r[n]['rand']}" for n in names)
            + " |")
    st = p["stats"]
    lines += ["", "Ten seeds a row:", ""] + compact(p)
    lines += ["", f"{st['n']} seeds."]
    for n, s in st["runs"].items():
        lines.append(f"- {n}: oracle Z {s['Z_mean']:.2f} ± {s['Z_std']:.2f}; "
                     f"feasible at it: oracle {s['oracle_feasible']}, MMW "
                     f"{s['mmw_feasible']}, rand {s['rand_feasible']}")
    for k, d in st["diff"].items():
        lines.append(f"- Z {k}: mean {d['mean']:+.2f} (std {d['std']:.2f}); "
                     f"higher on {d['higher']}, lower on {d['lower']} seeds")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", required=True,
                    help="name=dir[,dir...]; the first is the reference")
    ap.add_argument("--cell", type=int, default=10)
    ap.add_argument("--tag", type=str, default="75")
    ap.add_argument("--out", type=str, required=True)
    a = ap.parse_args(argv)
    runs = {}
    for spec in a.run:
        name, dirs = spec.split("=", 1)
        runs[name] = load_run(dirs.split(","), a.cell, a.tag)
    p = pair(runs)
    with open(a.out, "w") as f:
        f.write("\n".join(render(p)) + "\n")
    with open(os.path.splitext(a.out)[0] + ".json", "w") as f:
        json.dump(p, f, indent=1)
    print("\n".join(render(p)[-(2 + len(runs) + len(p["stats"]["diff"])):]))
    return p


if __name__ == "__main__":
    main()
