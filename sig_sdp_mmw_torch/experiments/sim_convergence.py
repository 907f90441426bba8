"""Max-violation convergence sweeps vs density rho and power offset alpha.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_convergence` (reference
``sim_script/ton_major_rv/sim_convergence_rho.py`` and
``sim_convergence_alp.py``): the exact oracle finds Z, then MMW runs with
eta=0.04, nit=ceil(1/eta^2)=625 (50 in ``--smoke``) and the gap log, and
the UB (max violation of the averaged X) trajectory is logged:

* rho sweep:   ``conv-rho-<cell>-<rho*1e4>``
* alpha sweep: ``conv-alp-<cell>-<alpha*100>`` (txp_offset = alpha + 1)

Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_convergence --repeat 1
"""

import math

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=20, cells=[10])
    p.add_argument("--rhos", type=float, nargs="*",
                   default=[25e-4, 50e-4, 75e-4, 100e-4, 125e-4])
    p.add_argument("--alphas", type=float, nargs="*",
                   default=[0.25, 0.5, 1.0, 2.0, 4.0])
    p.add_argument("--eta", type=float, default=0.04)
    args = p.parse_args(argv)
    setup(args)
    if args.smoke:
        args.rhos, args.alphas = [75e-4], [1.0]
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation)

    NIT = math.ceil(1.0 / args.eta ** 2) if not args.smoke else 50

    def run_one(e, name, seed):
        st = e.generate_S_Q_hmax()
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = ADMMSDPSolver(nit=1000)
        _, Z_fin, _ = bs.run(st)
        alg = MMW(nit=NIT, eta=args.eta, log_gap=True, seed=seed)
        alg.run_with_state(0, Z_fin, st)
        ub = alg.LOGGED_NP_DATA["gap"][:, 3]
        log.log_mul_scalar(name, seed, ub.tolist())

    for cell in args.cells:
        for rho in args.rhos:
            for seed in range(args.repeat):
                e = WirelessEnv(cell_size=cell, sta_density_per_1m2=rho,
                                seed=seed, device=args.device)
                run_one(e, f"conv-rho-{cell}-{int(rho * 10000)}", seed)
        for alpha in args.alphas:
            for seed in range(args.repeat):
                e = WirelessEnv(cell_size=cell, sta_density_per_1m2=args.rho,
                                txp_offset=alpha + 1.0, seed=seed,
                                device=args.device)
                run_one(e, f"conv-alp-{cell}-{int(alpha * 100)}", seed)
    log.close()
    return path


if __name__ == "__main__":
    main()
