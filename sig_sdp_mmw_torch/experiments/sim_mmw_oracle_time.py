"""End-to-end solve time: MMW vs the exact oracle vs MMW without bounds.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_mmw_oracle_time` (reference
``sim_script/journal_version/sim_mmw_scs_iter_time.py``, the paper's
headline wall-clock figure): for growing K, time binary-search pipelines
driven by (a) MMW-150, (b) the exact oracle (ADMM here, SCS in the
reference), (c) MMW with ``force_full_bound`` (no degree bounds).  Logs
``<name>-time-<cell>-<rho*1e4>`` rows [K, Z, wall_us] (host clock, after the
device is done).  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_mmw_oracle_time --cells 5 9 \\
        --repeat 1
"""

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    args = experiment_args(__doc__, repeat=3,
                           cells=list(range(5, 16, 2))).parse_args(argv)
    setup(args)
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation)

    tag = str(int(args.rho * 10000))
    for cell in args.cells:
        for seed in range(args.repeat):
            e = WirelessEnv(cell_size=cell, sta_density_per_1m2=args.rho,
                            seed=seed, device=args.device)
            st = e.generate_S_Q_hmax()

            def timed_run(name, alg, force_full=False):
                bs = BinarySearchRelaxation()
                bs.force_full_bound = force_full
                bs.feasibility_check_alg = alg
                tic = bs._get_tic()
                _, Z_fin, _ = bs.run(st)
                tim = bs._get_tim(tic)
                log.log_mul_scalar(f"{name}-time-{cell}-{tag}", seed,
                                   [st.K, Z_fin, tim])

            timed_run("mmw150", MMW(nit=150, eta=0.04, seed=seed))
            timed_run("oracle", ADMMSDPSolver(nit=500))
            timed_run("mmw150nb", MMW(nit=150, eta=0.04, seed=seed),
                      force_full=True)
    log.close()
    return path


if __name__ == "__main__":
    main()
