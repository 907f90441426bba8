"""Where the port and the JAX package part on the matched-Z oracle study's
users, on the CPU in float32.

For each seed of ``tests/fixtures/oracle_z_cell10_geometry.npz`` (the JAX
package's users, see ``torch_jax_geometry.py``):

* the oracle: the JAX search (``BinarySearchRelaxation`` +
  ``ADMMSDPSolver(nit)``) on its own state, and the port's on its state
  from the same users with the JAX package's rounding draws
  (``fold_in(PRNGKey(1234), n)``, as ``test_torch_admm.py`` gives them);
  the first probe whose Z or remainder differs; at that probe's Z, the ADMM
  solve of each (and the port's on the JAX state), ``max|ΔX_final|``, and
  the remainder of each rounding on each factor with that probe's draws
  (the factors swapped between the two roundings);
* MMW at ``--mmw-z`` (the study's ``MMW(nit=150, eta=0.04, seed=s)``, one
  solve and its rounding, the port with the JAX package's sketch and
  rounding draws): ``ub_final`` of each, ``max|ΔX_half|`` after each
  column's sign is aligned, and the remainders with the factors swapped.

No x64: float32 as the study runs.  JSON to ``--out``:

    PYTHONPATH=. python tests/torch_jax_oracle_split.py --seeds 2 5 \\
        --mmw SEED:Z ... --out split.json

``--jax-probes SEED`` prints instead, as one JSON line, the JAX search's
probes in float64 at nit 100 (``test_torch_oracle_parity.py`` runs it in a
child process as the reference of its search case).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CELL, RHO = 10, 0.0075


def _states(seed, geo):
    import jax
    import torch

    from sig_sdp_mmw_torch.core.problem import from_jax_arrays
    from sig_sdp_mmw_torch.env import WirelessEnv as TEnv
    from sig_sdp_mmw_tpu.env import WirelessEnv as JEnv
    from torch_jax_parity import jax_fields

    with jax.enable_x64(False):
        js = JEnv(cell_size=CELL, sta_density_per_1m2=RHO,
                  seed=seed).generate_S_Q_hmax()
    ts = TEnv(cell_size=CELL, sta_density_per_1m2=RHO, seed=seed,
              device="cpu", sta_locs=geo["sta_locs"][seed],
              sta_dirs=geo["sta_dirs"][seed]).generate_S_Q_hmax()
    tj = from_jax_arrays(jax_fields(js))
    dS = float(torch.max(torch.abs(ts.S - tj.S)) / torch.max(torch.abs(tj.S)))
    return js, ts, tj, dS


def _round_all(Z, factors, js, ts, key):
    """{(rounding, factor): rem} with the same draws (``key``)."""
    import torch

    from sig_sdp_mmw_torch.models.rounding import rounding as t_round
    from sig_sdp_mmw_tpu.models.rounding import rounding as j_round
    from torch_jax_parity import JaxDraws

    out = {}
    for fname, X in factors.items():
        Xn = np.asarray(X, np.float32)
        out[f"jax_rounding({fname})"] = int(j_round(Z, Xn, js, key)[2])
        out[f"port_rounding({fname})"] = int(t_round(
            Z, torch.from_numpy(Xn), ts, JaxDraws(key, nattempt=10))[2])
    return out


def oracle_split(seed, geo, nit=500):
    import jax
    import torch

    from sig_sdp_mmw_torch.models import BinarySearchRelaxation
    from sig_sdp_mmw_torch.models import admm as ta
    from sig_sdp_mmw_torch.models import base as tbase
    from sig_sdp_mmw_tpu.models import BinarySearchRelaxation as JBS
    from sig_sdp_mmw_tpu.models import admm as ja
    from torch_jax_parity import JaxDraws

    js, ts, tj, dS = _states(seed, geo)
    jbs = JBS()
    jbs.feasibility_check_alg = ja.ADMMSDPSolver(nit=nit)
    Zj = jbs.run(js)[1]
    pj = jbs.LOGGED_NP_DATA["bs_search_per_it"][:, 6:8].astype(int).tolist()
    tbase_draws = tbase.TorchDraws
    tbase.TorchDraws = lambda s, device, stream: JaxDraws(
        jax.random.fold_in(jax.random.PRNGKey(s), stream))
    try:
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = ta.ADMMSDPSolver(nit=nit)
        Zt = bs.run(ts)[1]
    finally:
        tbase.TorchDraws = tbase_draws
    pt = bs.LOGGED_NP_DATA["bs_search_per_it"][:, 6:8].astype(int).tolist()
    rec = dict(seed=seed, nit=nit, jax_Z=int(Zj), port_Z=int(Zt),
               jax_probes=pj, port_probes=pt, state_rel_dS=dS)
    k = next((i for i, (a, b) in enumerate(zip(pj, pt)) if a != b), None)
    if k is None:
        return rec
    Z = pj[k][0]
    _, ub = ts.degree_bounds()
    rank_pad = min(((max(Z, ub) * 2 + 15) // 16) * 16, ts.Kp - 1)
    with jax.enable_x64(False):
        Hj, Xj = ja.admm_sdp_solve(js, float(Z), nit=nit, rank_pad=rank_pad,
                                   rank_radio=2)
    Ht, Xt = ta.admm_sdp_solve(ts, float(Z), nit=nit, rank_pad=rank_pad)
    Htj, Xtj = ta.admm_sdp_solve(tj, float(Z), nit=nit, rank_pad=rank_pad)
    Xj = np.asarray(Xj)
    key = jax.random.fold_in(jax.random.PRNGKey(1234), k + 1)
    rec.update(
        first_split_probe=k, split_Z=Z, X_absmax=float(np.abs(Xj).max()),
        max_dX_final=float(np.abs(Xt.numpy() - Xj).max()),
        max_dX_final_on_jax_state=float(np.abs(Xtj.numpy() - Xj).max()),
        rem=_round_all(Z, {"jax": Hj, "port": Ht.numpy(),
                           "port_on_jax_state": Htj.numpy()}, js, ts, key))
    return rec


def jax_search_probes_f64(seed, geo, nit=100):
    """The JAX search's probes (lo, hi, mid, Z, rem) and Z_fin on seed's
    users in float64 (the geometry cast to float64 before the JAX env
    computes it, as the port computes it): the reference of
    ``test_torch_oracle_parity.py``'s search case (``--jax-probes``)."""
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.problem import state_from_arrays
    from sig_sdp_mmw_tpu.env import WirelessEnv as JEnv
    from sig_sdp_mmw_tpu.env.env import state_arrays_from_rxpr
    from sig_sdp_mmw_tpu.models import BinarySearchRelaxation as JBS
    from sig_sdp_mmw_tpu.models import admm as ja

    jax.config.update("jax_enable_x64", True)
    je = JEnv(cell_size=CELL, sta_density_per_1m2=RHO, seed=seed)
    je.sta_locs = jnp.asarray(geo["sta_locs"][seed].astype(np.float64))
    S, Q, h, _ = state_arrays_from_rxpr(je.rxpr(), je.params)
    js = state_from_arrays(np.asarray(S), np.asarray(Q), np.asarray(h),
                           dtype=jnp.float64)
    jbs = JBS()
    jbs.feasibility_check_alg = ja.ADMMSDPSolver(nit=nit)
    Z = jbs.run(js)[1]
    probes = jbs.LOGGED_NP_DATA["bs_search_per_it"][:, 3:8].astype(int)
    return probes.tolist(), int(Z)


def _align(A, B):
    """B with each column's sign set to agree with A's."""
    s = np.sign(np.sum(A * B, axis=0))
    return B * np.where(s == 0, 1.0, s)[None, :]


def mmw_split(seed, Z, geo, nit=150, eta=0.04):
    import jax
    import torch

    from sig_sdp_mmw_torch.models import MMW as TMMW
    from sig_sdp_mmw_torch.models import mmw as tm
    from sig_sdp_mmw_tpu.models import MMW as JMMW
    from torch_jax_parity import JaxDraws

    js, ts, tj, dS = _states(seed, geo)
    with jax.enable_x64(False):
        jm = JMMW(nit=nit, eta=eta, seed=seed)
        _, Hj = jm.run_with_state(0, Z, js)
        ubj = float(jm.last_output.ub_final)
    Hj = np.asarray(Hj)
    draws = tm.TorchDraws
    tm.TorchDraws = lambda s, device, stream: JaxDraws(
        jax.random.fold_in(jax.random.PRNGKey(s), stream), nit=nit)
    out = {}
    try:
        for name, st in (("port", ts), ("port_on_jax_state", tj)):
            m = TMMW(nit=nit, eta=eta, seed=seed)
            _, H = m.run_with_state(0, Z, st)
            H = H.numpy()
            out[name] = dict(ub_final=float(m.last_output.ub_final),
                             max_dX_half_aligned=float(
                                 np.abs(_align(Hj, H) - Hj).max()),
                             max_dX_half_raw=float(np.abs(H - Hj).max()),
                             X=H)
    finally:
        tm.TorchDraws = draws
    key = jax.random.fold_in(jax.random.PRNGKey(1234), 1)
    rem = _round_all(Z, {"jax": Hj, **{n: o.pop("X") for n, o in out.items()}},
                     js, ts, key)
    return dict(seed=seed, Z=Z, nit=nit, jax_ub_final=ubj,
                H_absmax=float(np.abs(Hj).max()), state_rel_dS=dS, rem=rem,
                **out)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from torch_jax_geometry import FIXTURE

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--mmw", nargs="*", default=[],
                    help="SEED:Z pairs for the MMW comparison")
    ap.add_argument("--nit", type=int, default=500)
    ap.add_argument("--jax-probes", type=int, default=None, metavar="SEED",
                    help="print the JAX search's float64 probes at nit 100 "
                         "on SEED's users as JSON (the parity test's "
                         "reference)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.jax_probes is not None:
        print(json.dumps(jax_search_probes_f64(a.jax_probes,
                                               dict(np.load(FIXTURE)))))
        sys.exit(0)
    if a.out is None:
        ap.error("--out is required")
    torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    geo = dict(np.load(FIXTURE))
    recs = {"oracle": [], "mmw": []}

    def save():
        with open(a.out, "w") as f:
            json.dump(recs, f, indent=1)

    for s in a.seeds:
        t0 = time.time()
        recs["oracle"].append(dict(oracle_split(s, geo, a.nit),
                                   seconds=time.time() - t0))
        print(json.dumps(recs["oracle"][-1]), flush=True)
        save()
    for sz in a.mmw:
        s, Z = map(int, sz.split(":"))
        t0 = time.time()
        recs["mmw"].append(dict(mmw_split(s, Z, geo),
                                seconds=time.time() - t0))
        print(json.dumps(recs["mmw"][-1]), flush=True)
        save()
