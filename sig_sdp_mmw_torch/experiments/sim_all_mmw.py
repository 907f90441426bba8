"""Duality-gap telemetry sweep over eta, vs the exact-oracle Z.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_all_mmw` (reference
``sim_script/journal_version/sim_all_mmw.py``): the ADMM oracle (the SCS
stand-in) finds Z_fin; MMW runs at that Z with nit = ceil(1/eta^2) and the
gap log on; the UB and LB rows are logged under
``mmw-dual-<cell>-<eta*100>``.  The oracle's Z is eta-independent, so it is
searched once per (cell, seed).  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_all_mmw --cells 10 --repeat 1
"""

import math

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=20)
    p.add_argument("--etas", type=float, nargs="*",
                   default=[0.02, 0.04, 0.06, 0.08, 0.10])
    args = p.parse_args(argv)
    setup(args)
    if args.smoke:
        args.etas = [0.1]
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation)

    z_cache = {}        # (cell, seed) -> the oracle's Z_fin
    for cell in args.cells:
        for eta in args.etas:
            nit = math.ceil(1.0 / eta / eta)
            for seed in range(args.repeat):
                e = WirelessEnv(cell_size=cell, sta_density_per_1m2=args.rho,
                                seed=seed, device=args.device)
                st = e.generate_S_Q_hmax()

                if (cell, seed) not in z_cache:
                    bs = BinarySearchRelaxation()
                    bs.feasibility_check_alg = ADMMSDPSolver(nit=1000)
                    _, z_cache[(cell, seed)], _ = bs.run(st)
                Z_fin = z_cache[(cell, seed)]

                alg = MMW(nit=nit, eta=eta, log_gap=True, seed=seed)
                alg.run_with_state(0, Z_fin, st)
                gap = alg.LOGGED_NP_DATA["gap"]
                ub, lb = gap[:, 3], gap[:, 4]
                name = f"mmw-dual-{cell}-{int(eta * 100)}"
                log.log_mul_scalar(name, seed, ub.tolist())
                log.log_mul_scalar(name, seed, lb.tolist())
    log.close()
    return path


if __name__ == "__main__":
    main()
