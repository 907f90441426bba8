"""Online BLER vs MMW iteration budget (latency/quality tradeoff).

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_online_iterations` (reference
``sim_script/ton_major_rv/sim_mmw_online_cmp_iterations.py``): the staleness
protocol of ``sim_online_methods``, with the MMW nit swept over {2, 10, 50,
100, 150}: fewer iterations solve faster (less user movement) at lower
relaxation quality.  Metric names ``online-mmw-<i>-<nit>-<cell>-<rho*1e4>``.
Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_online_iterations --repeat 1
"""

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=100, cells=[10])
    p.add_argument("--nits", type=int, nargs="*", default=[2, 10, 50, 100, 150])
    p.add_argument("--n_speed", type=int, default=11)
    p.add_argument("--speed", type=float, default=0.1)
    args = p.parse_args(argv)
    setup(args)
    if args.smoke:
        args.nits, args.n_speed = [10], 2
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import MobileEnv
    from sig_sdp_mmw_torch.models import MMW, BinarySearchRelaxation

    tag = str(int(args.rho * 10000))
    for cell in args.cells:
        for nit in args.nits:
            for seed in range(args.repeat):
                e = MobileEnv(cell_size=cell, sta_density_per_1m2=args.rho,
                              seed=seed, device=args.device)
                bs = BinarySearchRelaxation()
                tic = bs._get_tic()
                alg = MMW(nit=nit, eta=0.04, seed=seed)
                bs.feasibility_check_alg = alg
                _, Z_fin, _ = bs.run(e.generate_S_Q_hmax())
                _, gX = alg.run_with_state(0, Z_fin, e.generate_S_Q_hmax())
                tim = bs._get_tim(tic, sync=gX)
                for i in range(args.n_speed):
                    z_vec, _, _ = alg.rounding(Z_fin, gX,
                                               e.generate_S_Q_hmax())
                    bler = e.evaluate_bler(z_vec, Z_fin)
                    log.log_mul_scalar(
                        f"online-mmw-{i}-{nit}-{cell}-{tag}", seed,
                        bler.tolist())
                    e.step_time(tim, mob_spd_meter_s=args.speed)
    log.close()
    return path


if __name__ == "__main__":
    main()
