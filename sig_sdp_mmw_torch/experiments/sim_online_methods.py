"""Online/mobility staleness: BLER decay of a stale relaxation as users move
for the duration of the solver's own wall-clock latency.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_online_methods` (reference
``sim_script/ton_major_rv/sim_mmw_online_cmp_methods.py``): methods Proposed
(MMW-150), the exact oracle (ADMM; SCS in the reference), Ideal (MMW with
zero latency), Heuristic (MAX_GAIN, unbounded Z).  At each of N_SPEED
staleness steps the original relaxation factor gX is re-rounded against the
moved users' fresh state and evaluated
(``sim_mmw_online_cmp_methods.py:43-47``).  Metric names
``online-<method>-<i>-150-<cell>-<rho*1e4>``, values = per-user BLER.  Runs
on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_online_methods --repeat 1
"""

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=100, cells=[10])
    p.add_argument("--n_speed", type=int, default=11)
    p.add_argument("--speed", type=float, default=0.1)
    args = p.parse_args(argv)
    setup(args)
    if args.smoke:
        args.n_speed = 2
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import MobileEnv
    from sig_sdp_mmw_torch.models import (MAX_GAIN, MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation)

    tag = str(int(args.rho * 10000))

    def env(cell, seed):
        return MobileEnv(cell_size=cell, sta_density_per_1m2=args.rho,
                         seed=seed, device=args.device)

    def online(name, alg, cell, seed, ideal=False):
        e = env(cell, seed)
        bs = BinarySearchRelaxation()
        tic = bs._get_tic()
        bs.feasibility_check_alg = alg
        _, Z_fin, _ = bs.run(e.generate_S_Q_hmax())
        _, gX = alg.run_with_state(0, Z_fin, e.generate_S_Q_hmax())
        tim = bs._get_tim(tic, sync=gX)
        for i in range(args.n_speed):
            z_vec, _, _ = alg.rounding(Z_fin, gX, e.generate_S_Q_hmax())
            bler = e.evaluate_bler(z_vec, Z_fin)
            log.log_mul_scalar(f"online-{name}-{i}-150-{cell}-{tag}", seed,
                               bler.tolist())
            e.step_time(0.0 if ideal else tim, mob_spd_meter_s=args.speed)

    def online_heur(cell, seed):
        e = env(cell, seed)
        bs = BinarySearchRelaxation()
        tic = bs._get_tic()
        z_vec, Z_fin, _ = MAX_GAIN.run(-1, e.generate_S_Q_hmax(),
                                       not_Z_bound=True)
        tim = bs._get_tim(tic)
        for i in range(args.n_speed):
            bler = e.evaluate_bler(z_vec, Z_fin)
            log.log_mul_scalar(f"online-mgain-{i}-150-{cell}-{tag}", seed,
                               bler.tolist())
            e.step_time(tim, mob_spd_meter_s=args.speed,
                        resolution_us=10000.0)

    for cell in args.cells:
        for seed in range(args.repeat):
            online("mmw", MMW(nit=150, eta=0.04, seed=seed), cell, seed)
            online("admm", ADMMSDPSolver(nit=1000), cell, seed)
            online("ideal", MMW(nit=150, eta=0.04, seed=seed), cell, seed,
                   ideal=True)
            online_heur(cell, seed)
    log.close()
    return path


if __name__ == "__main__":
    main()
