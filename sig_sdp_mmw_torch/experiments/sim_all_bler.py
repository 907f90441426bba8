"""BLER comparison: MMW vs rand/LP/heuristics at the MMW-found Z.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_all_bler` (reference
``sim_script/journal_version/sim_all_bler.py``): for each (cell_size, seed),
binary search + MMW finds Z_fin, every method is rounded at that same Z, and
the full per-user BLER vector is logged per method under the reference's
metric names (``mmw-<cell>-<rho*1e4>``, ``rand-``, ``ladmm-``, ``mgain-``,
``masso-``; values = [Z] + bler).  Completed (cell, seed) items are recorded
in the output directory's ``checkpoint.jsonl`` and skipped on a rerun, which
appends to the metric files (the JAX script truncates them).  Each
instance also prints one ``[sim_all_bler]`` JSON line: every method's Z,
remainder, seconds (solve and rounding, host clock after the device is done),
share of users with BLER above 1e-5, and whether the independent checker
passes its assignment.  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_all_bler --cells 15 --repeat 1
"""

import json
import time

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def _rand(st, Z, seed):
    from sig_sdp_mmw_torch.models import RandSDPSolver

    rnd = RandSDPSolver(seed=seed)
    _, gX = rnd.run_with_state(0, Z, st)
    z_vec, _, rem = rnd.rounding(Z, gX, st)
    return z_vec, rem


def _lrp(st, Z, seed):
    from sig_sdp_mmw_torch.models import LRPSolver

    lrp = LRPSolver(nit=100, seed=seed)
    _, P = lrp.run_with_state(0, Z, st)
    z_vec, _, rem = lrp.rounding(Z, P, st)
    return z_vec, rem


def _heuristic(cls):
    def run(st, Z, seed):
        z_vec, _, rem = cls.run(Z, st)
        return z_vec, rem
    return run


def compare_at_z(e, st, Z: int, seed: int) -> dict:
    """The sweep's per-instance comparison at ``Z``: Rand, LRP, MAX_GAIN and
    MAX_ASSO, each rounded and put through BLER.  {metric prefix: (z_vec
    [K], rem, bler [K], seconds)}."""
    from sig_sdp_mmw_torch.models import MAX_ASSO, MAX_GAIN

    out = {}
    for name, method in (("rand", _rand), ("ladmm", _lrp),
                         ("mgain", _heuristic(MAX_GAIN)),
                         ("masso", _heuristic(MAX_ASSO))):
        t0 = time.time()
        z_vec, rem = method(st, Z, seed)
        out[name] = (z_vec, rem, e.evaluate_bler(z_vec, Z), time.time() - t0)
    return out


def main(argv=None):
    args = experiment_args(__doc__, repeat=100).parse_args(argv)
    setup(args)
    log, path = make_log(__file__, args.out, append=True)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MMW, BinarySearchRelaxation,
                                          verify_assignment)
    from sig_sdp_mmw_torch.utils.checkpoint import SweepCheckpoint

    RHO = args.rho
    tag = str(int(RHO * 10000))
    ck = SweepCheckpoint(path)

    for cell in args.cells:
        for seed in range(args.repeat):
            if ck.done(f"cell{cell}", seed):
                continue
            e = WirelessEnv(cell_size=cell, sta_density_per_1m2=RHO, seed=seed,
                            device=args.device)
            st = e.generate_S_Q_hmax()

            bs = BinarySearchRelaxation()
            bs.feasibility_check_alg = MMW(nit=150, eta=0.04, seed=seed)
            t0 = time.time()
            z_vec, Z_fin, rem = bs.run(st)
            mmw_s = time.time() - t0
            rows = {"mmw": (z_vec, rem, e.evaluate_bler(z_vec, Z_fin), mmw_s)}
            rows.update(compare_at_z(e, st, Z_fin, seed))
            for name, (_, _, bler, _) in rows.items():
                log.log_mul_scalar(f"{name}-{cell}-{tag}", seed,
                                   [Z_fin] + bler.tolist())
            ck.mark(f"cell{cell}", seed)
            print("[sim_all_bler] " + json.dumps({
                "cell": cell, "seed": seed, "K": st.K, "Z": Z_fin,
                "methods": {name: {"rem": int(r), "s": s,
                                   "bler_frac_above_1e-5":
                                       float((bler > 1e-5).mean()),
                                   "verified": verify_assignment(st, z)[0]}
                            for name, (z, r, bler, s) in rows.items()}}),
                flush=True)
    ck.close()
    log.close()
    return path


if __name__ == "__main__":
    main()
