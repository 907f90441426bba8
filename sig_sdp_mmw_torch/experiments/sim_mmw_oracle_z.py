"""Matched-Z oracle validation: exact-oracle search, MMW/rand at that Z.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_mmw_oracle_z` (reference
``sim_script/journal_version/sim_mmw_scs.py:20-60``), the journal's central
validation.  For each (cell, seed):

1. the exact SDP oracle (the ADMM consensus split standing in for SCS)
   drives the binary search to its min feasible Z (logged as
   ``scs-<cell>-<rho*1e4>``);
2. MMW (nit=150, eta=0.04) solves one probe at that same Z and rounds,
   comparing decisions at matched Z (``mmw150-<cell>-<rho*1e4>``);
3. the random baseline is rounded at that Z (``rand-<cell>-<rho*1e4>``).

Each CSV row holds ``[Z, rem] + per-user BLER``.  Completed items are
checkpointed as in ``sim_all_bler`` (a rerun with the same ``--out`` skips
them and appends).  Each instance also prints one
``[sim_mmw_oracle_z]`` JSON line with the oracle's Z and every method's
remainder and seconds.  Runs on ``--device`` (default cuda).

``--geometry <npz>`` places seed s's users at the npz's ``sta_locs[s]`` and
``sta_dirs[s]`` in place of the port's own draws: with
``tests/fixtures/oracle_z_cell10_geometry.npz`` (the JAX package's users of
seeds 0-99 at cell 10) the study runs on the users of the JAX record.  It
changes the input only; the solvers, the rounding and their draws stay.

    python -m sig_sdp_mmw_torch.experiments.sim_mmw_oracle_z --cells 10 \\
        --repeat 1 [--geometry tests/fixtures/oracle_z_cell10_geometry.npz]
"""

import json
import time

import numpy as np

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  placed_users, setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=100, cells=[10])
    p.add_argument("--oracle_nit", type=int, default=500)
    p.add_argument("--mmw_nit", type=int, default=150)
    p.add_argument("--geometry", type=str, default=None,
                   help="npz of sta_locs/sta_dirs [seeds, K, 2]: seed s "
                        "takes row s")
    p.add_argument("--seeds", type=int, nargs="*", default=None,
                   help="these seeds in place of 0..repeat-1 (one process "
                        "of a sweep split over several)")
    args = p.parse_args(argv)
    setup(args)
    log, path = make_log(__file__, args.out, append=True)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation,
                                          RandSDPSolver)
    from sig_sdp_mmw_torch.utils.checkpoint import SweepCheckpoint

    RHO = args.rho
    tag = str(int(RHO * 10000))
    ck = SweepCheckpoint(path)
    geo = dict(np.load(args.geometry)) if args.geometry else None

    for cell in args.cells:
        for seed in (args.seeds if args.seeds is not None
                     else range(args.repeat)):
            if ck.done(f"cell{cell}", seed):
                continue
            e = WirelessEnv(cell_size=cell, sta_density_per_1m2=RHO,
                            seed=seed, device=args.device,
                            **placed_users(geo, seed))
            st = e.generate_S_Q_hmax()
            secs, rems = {}, {}

            t0 = time.time()
            bs = BinarySearchRelaxation()
            bs.feasibility_check_alg = ADMMSDPSolver(nit=args.oracle_nit)
            z_vec, Z_orc, rems["scs"] = bs.run(st)
            secs["scs"] = time.time() - t0
            bler = e.evaluate_bler(z_vec, Z_orc)
            log.log_mul_scalar(f"scs-{cell}-{tag}", seed,
                               [Z_orc, rems["scs"]] + bler.tolist())

            for name, alg in (("mmw150", MMW(nit=args.mmw_nit, eta=0.04,
                                              seed=seed)),
                              ("rand", RandSDPSolver(seed=seed))):
                t0 = time.time()
                _, gX = alg.run_with_state(0, Z_orc, st)
                z_vec, _, rems[name] = alg.rounding(Z_orc, gX, st)
                secs[name] = time.time() - t0
                bler = e.evaluate_bler(z_vec, Z_orc)
                log.log_mul_scalar(f"{name}-{cell}-{tag}", seed,
                                   [Z_orc, rems[name]] + bler.tolist())
            ck.mark(f"cell{cell}", seed)
            print("[sim_mmw_oracle_z] " + json.dumps({
                "cell": cell, "seed": seed, "K": st.K, "Z": Z_orc,
                "probe_Z": bs.LOGGED_NP_DATA["bs_search_per_it"][:, 5]
                .astype(int).tolist(),
                "rem": {k: int(v) for k, v in rems.items()}, "s": secs}),
                flush=True)
    ck.close()
    log.close()
    return path


if __name__ == "__main__":
    main()
