"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload sig100k.search --seed 7 \\
        --seconds 51 --trace 0

(``python -m portbench.run`` from the checkout's root does the same.)
Needs a CUDA device: without one it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()          # setup_s counts from here

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.harness import main

    sys.exit(main(t_start=T_START))
