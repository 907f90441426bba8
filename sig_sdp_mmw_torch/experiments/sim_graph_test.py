"""Problem-size envelope: users K, max degree Omega, constraint count C.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_graph_test` (reference
``sim_script/journal_version/sim_graph_test.py``): sweeps grid size and
density and logs the interference-graph statistics that size the padded
buffers, ``graph-<cell>-<rho*1e4>`` rows [K, Omega, C, nnz_S, nnz_Q].  Runs
on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_graph_test --repeat 1
"""

import numpy as np

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=10)
    p.add_argument("--rhos", type=float, nargs="*",
                   default=[50e-4, 75e-4, 100e-4])
    args = p.parse_args(argv)
    setup(args)
    if args.smoke:
        args.rhos = [75e-4]
    log, path = make_log(__file__, args.out)

    from sig_sdp_mmw_torch.env import WirelessEnv

    for cell in args.cells:
        for rho in args.rhos:
            for seed in range(args.repeat):
                e = WirelessEnv(cell_size=cell, sta_density_per_1m2=rho,
                                seed=seed, device=args.device)
                st = e.generate_S_Q_hmax()
                K = st.K
                S = st.S.cpu().numpy()[:K, :K]
                Q = st.Q.cpu().numpy()[:K, :K]
                Ssym = (S != 0) | (S.T != 0)
                np.fill_diagonal(Ssym, False)
                omega = int(Ssym.sum(axis=1).max()) + 1
                E_asso = int((Q != 0).sum() // 2)
                C = E_asso + 2 * K
                log.log_mul_scalar(f"graph-{cell}-{int(rho * 10000)}", seed,
                                   [K, omega, C, int((S != 0).sum()),
                                    int((Q != 0).sum())])
    log.close()
    return path


if __name__ == "__main__":
    main()
