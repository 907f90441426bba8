"""Per-phase MMW timing breakdown vs problem size (the dense path).

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_mmw_time` (reference
``sim_script/journal_version/sim_mmw_time.py``): per (cell, seed), a binary
search with ``MMW(nit=150, eta=0.04)``, then a profiled solve at the Z it
found and one rounding; logs the mean [all_it, dual, loss, expm, xavg,
rounding] microseconds under ``mmw150-time-<cell>-<rho*1e4>``, and the
per-solve time of the unprofiled solve (second of two calls) under
``mmw150-fused-<cell>-<rho*1e4>``.  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_mmw_time --cells 10 15 \\
        --repeat 1 --out runs/mmw_time
"""

import numpy as np

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    args = experiment_args(__doc__, repeat=5).parse_args(argv)
    setup(args)
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import MMW, BinarySearchRelaxation

    tag = str(int(args.rho * 10000))
    for cell in args.cells:
        for seed in range(args.repeat):
            e = WirelessEnv(cell_size=cell, sta_density_per_1m2=args.rho,
                            seed=seed, device=args.device)
            st = e.generate_S_Q_hmax()
            bs = BinarySearchRelaxation()
            bs.feasibility_check_alg = MMW(nit=150, eta=0.04, seed=seed)
            z_vec, Z_fin, rem = bs.run(st)

            alg = MMW(nit=150, eta=0.04, seed=seed + 1)
            _, X_half = alg.run_with_state_profiled(0, Z_fin, st)
            tic = alg._get_tic()
            alg.rounding(Z_fin, X_half, st)
            tim_rnd = alg._get_tim(tic)

            tab = alg.LOGGED_NP_DATA
            times = [np.mean(tab["mmw_all_it"][:, 5]),
                     np.mean(tab["mmw_dual"][:, 5]),
                     np.mean(tab["mmw_loss"][:, 5]),
                     np.mean(tab["mmw_expm"][:, 5]),
                     np.mean(tab["mmw_xavg"][:, 5]),
                     tim_rnd]
            log.log_mul_scalar(f"mmw150-time-{cell}-{tag}", seed, times)

            # The unprofiled solve of the same work: a first call, then the
            # timed one.
            alg2 = MMW(nit=150, eta=0.04, seed=seed + 2)
            alg2.run_with_state(0, Z_fin, st)
            alg2.run_with_state(1, Z_fin, st)
            fused = alg2.LOGGED_NP_DATA["mmw_all_it"][-1, 5]
            log.log_mul_scalar(f"mmw150-fused-{cell}-{tag}", seed, [fused])
    log.close()
    return path


if __name__ == "__main__":
    main()
