"""End-to-end demo: one scenario through every solver family.

Port of :mod:`sig_sdp_mmw_tpu.experiments.pd_mmw_template` (reference
``sim_script/pd_mmw_template.py``): build a cell_size=10 scenario, run binary
search + MMW (with the gap log), then compare LP, the exact oracle and the
three heuristics at the MMW-found Z.  Returns one row per method, (name, Z,
rem, mean BLER, max BLER).  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.pd_mmw_template --seed 0
"""

from sig_sdp_mmw_torch.experiments.common import experiment_args, setup


def main(argv=None):
    p = experiment_args(__doc__, repeat=1, cells=[10])
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    setup(args)

    import time

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MAX_ASSO, MAX_GAIN, MAX_RAND, MMW,
                                          ADMMSDPSolver,
                                          BinarySearchRelaxation, LRPSolver)

    seed = args.seed if args.seed is not None else int(time.time())
    cell = args.cells[0]
    e = WirelessEnv(cell_size=cell, sta_density_per_1m2=1e-2, seed=seed,
                    device=args.device)
    print("users:", e.n_sta)
    st = e.generate_S_Q_hmax()

    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = MMW(nit=400, eta=0.05, log_gap=True, seed=seed)
    z_vec, Z_fin, rem = bs.run(st)
    bler = e.evaluate_bler(z_vec, Z_fin)
    print(Z_fin, rem, bler.mean(), bler.max(), "mmw")
    results = [("mmw", Z_fin, rem, bler.mean(), bler.max())]

    for name, alg in (("lrp", LRPSolver(nit=100)),
                      ("admm", ADMMSDPSolver(nit=100))):
        _, gX = alg.run_with_state(0, Z_fin, st)
        z_vec, Z, _ = alg.rounding(Z_fin, gX, st)
        bler = e.evaluate_bler(z_vec, Z)
        # The MMW search's remainder, as the reference prints it.
        print(Z, rem, bler.mean(), bler.max(), name)
        results.append((name, Z, rem, bler.mean(), bler.max()))

    for heur, name in ((MAX_GAIN, "mgain"), (MAX_ASSO, "masso"),
                       (MAX_RAND, "mrand")):
        z_vec, Z, r = heur.run(Z_fin, st)
        bler = e.evaluate_bler(z_vec, Z)
        print(Z, r, bler.mean(), bler.max(), name)
        results.append((name, Z, r, bler.mean(), bler.max()))
    return results


if __name__ == "__main__":
    main()
