"""The correctness controls, run on a cell at its own size; their checks
have to come out over their limits (``correct`` false).  The benchmark's
own runs never run them.

* ``products``: the reference's solve with every operator product taken
  one precision below the configuration's (``control_products``), put in
  the port's place: its bound is what ``ub_gap`` reads;
* ``state``: the state the port is handed, rounded to bfloat16, below the
  configurations' float32.

    python3 portbench/control.py --workload sig300.schedule --seeds 1 2 3 \\
        --seconds 51 --what products

Prints one JSON line per seed: ``correct`` and every check's reading.
Each deployment's module (``portbench/systems/<system>.py``) makes the
hooks of its controls (``control_hooks``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys


def hooks_for(spec, what: str = "products") -> dict:
    cfg = spec["config_file"]
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    return system.control_hooks(cfg, what)


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--what", choices=("products", "state"),
                    default="products")
    a = ap.parse_args(argv)
    spec = harness.cell_spec(a.workload)
    for seed in a.seeds:
        r = harness.run_cell(a.workload, seed, a.seconds, False,
                             hooks=hooks_for(spec, a.what))
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "what": a.what, "correct": r["correct"],
                          "failed": r["failed"],
                          "attempted": r["attempted"],
                          "checks": r["checks"], "info": r["info"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
