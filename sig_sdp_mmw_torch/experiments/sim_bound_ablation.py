"""Binary-search bound ablation: degree bounds vs no bounds.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_bound_ablation` (reference
``sim_script/conference_version/sim_sadmm_niter.py:26-59``): for each (rho,
cell, seed), run the full binary search twice, once with the graph degree
bounds and once with ``force_full_bound`` (window [1, K]), and log the probe
counts and wall times under the reference's metric names
(``g_bound_iter_list-...`` / ``n_bound_time_list-...``).

The feasibility oracle is the ADMM SDP solver at nit=100, as in the
reference; ``--alg mmw`` swaps in MMW-150.  Runs on ``--device`` (default
cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_bound_ablation --cells 5 \\
        --repeat 2
"""

import numpy as np

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def _make_alg(name, seed):
    from sig_sdp_mmw_torch.models import MMW, ADMMSDPSolver

    if name == "mmw":
        return MMW(nit=150, eta=0.04, seed=seed)
    return ADMMSDPSolver(nit=100)


def main(argv=None):
    p = experiment_args(__doc__, repeat=20, cells=list(range(5, 16)))
    p.add_argument("--rhos", type=float, nargs="*", default=[50e-4, 100e-4])
    p.add_argument("--alg", choices=["admm", "mmw"], default="admm")
    args = p.parse_args(argv)
    setup(args)
    if args.smoke:
        args.rhos = args.rhos[:1]
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import BinarySearchRelaxation

    for rho in args.rhos:
        tag_rho = str(int(rho * 10000))
        for cell in args.cells:
            g_iters, g_times, n_iters, n_times = [], [], [], []
            for seed in range(args.repeat):
                e = WirelessEnv(cell_size=cell, sta_density_per_1m2=rho,
                                seed=seed, device=args.device)
                st = e.generate_S_Q_hmax()

                for full, iters, times in ((False, g_iters, g_times),
                                           (True, n_iters, n_times)):
                    bs = BinarySearchRelaxation()
                    bs.force_full_bound = full
                    bs.feasibility_check_alg = _make_alg(args.alg, seed)
                    tic = bs._get_tic()
                    bs.run(st)
                    tim = bs._get_tim(tic)
                    iters.append(bs.LOGGED_NP_DATA["bs_search_per_it"].shape[0])
                    times.append(tim)

            tag = f"{cell}-{tag_rho}"
            log.log_mul_scalar(f"g_bound_iter_list-{tag}", 0, g_iters)
            log.log_mul_scalar(f"g_bound_time_list-{tag}", 0, g_times)
            log.log_mul_scalar(f"n_bound_iter_list-{tag}", 0, n_iters)
            log.log_mul_scalar(f"n_bound_time_list-{tag}", 0, n_times)
            print(f"cell={cell} rho={rho}: probes g={np.mean(g_iters):.1f} "
                  f"n={np.mean(n_iters):.1f}  time g={np.mean(g_times)/1e6:.2f}s "
                  f"n={np.mean(n_times)/1e6:.2f}s", flush=True)
    log.close()
    return path


if __name__ == "__main__":
    main()
