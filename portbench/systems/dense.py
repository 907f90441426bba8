"""The journal's dense deployment as the port serves it: users handed to
the port's ``WirelessEnv``, which derives the state on the device, and
its dense MMW solver.

The judgement derives each request's state again from the same users in
float64 (:func:`portbench.reference.state.dense_state`) and reads the
port's state, answers, solver bounds and searches against it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from portbench import judge as pj
from portbench.reference import mmw, recount, search
from portbench.reference.state import dense_state, params_of


def port_state(cfg, locs, dirs, device, hooks):
    """The port's state of the users at ``locs``: a fresh ``WirelessEnv``
    given the users (a control may put its own state in its place)."""
    from sig_sdp_mmw_torch.env.env import WirelessEnv

    s = cfg["scenario"]
    env = WirelessEnv(cell_size=s["cell_size"],
                      sta_density_per_1m2=s["sta_density_per_1m2"],
                      sta_locs=locs, sta_dirs=dirs, device=device)
    st = env.generate_S_Q_hmax()
    return hooks["state"](st) if "state" in hooks else st


def make_alg(cfg, seed):
    from sig_sdp_mmw_torch.models.mmw import MMW

    sv = cfg["solver"]
    return MMW(nit=sv["nit"], rank_radio=sv["rank_radio"], eta=sv["eta"],
               seed=seed)


def port_verify(st, z) -> bool:
    from sig_sdp_mmw_torch.models.rounding import verify_assignment

    return bool(verify_assignment(st, z)[0])


def judge_answers(cfg, answers, limits: dict, sample: int, seed: int,
                  hooks: dict, device):
    """(checks, failed, n_judged).  Every answer is recounted on the
    reference's state of its users: one that claims every user a slot has
    to keep the guarantees, and a probe that claimed users left over may
    not hold a schedule that keeps them.  The port's state is compared with
    the reference's on ``sample`` requests drawn from the seed (all when
    fewer), the longest among them; the bounds of the solves of the longest
    request and of one more drawn from the seed are solved again by the
    reference.  Each search's probes and result are held against the
    reference's bisection."""
    p = params_of(cfg)
    over, broken, err, wrong, n = 0.0, 0, 0.0, 0, 0
    gaps, mism = [], 0
    done = [a for a in answers if not a.get("error")]
    failed = len(answers) - len(done)
    rng = np.random.default_rng([int(seed), 7])
    pick = set(rng.choice(len(done), size=min(sample, len(done)),
                          replace=False).tolist()) if done else set()
    pick_ub = set()
    if done:
        longest = int(np.argmax([a["t1"] - a["t0"] for a in done]))
        pick.add(longest)
        pick_ub = {longest, int(rng.integers(len(done)))}
    refs = {}
    for i, a in enumerate(done):
        key = a["users"]
        if key not in refs:
            refs[key] = dense_state(p, a["locs"])
        S, Q, h, raw = refs[key]
        K = S.shape[0]
        # The recount judges; the port's own check (``port_ok``) is
        # reported (portbench.judge.port_rejected).
        bad = False
        if a["rem"] == 0:
            o, b = recount.recount(S, Q, h, a["z"][:K], a["Z"])
            over, broken, n = max(over, o), max(broken, b), n + 1
            bad = bad or o > limits["overload"] or b > limits["broken"]
        for pr in a.get("probes", []):
            if pr["rem"] != 0:
                o, b = recount.recount(S, Q, h, pr["z"][:K], pr["Z"])
                c = o <= limits["overload"] and b <= limits["broken"]
                wrong, bad = wrong + int(c), bad or c
        if "probes" in a:
            m, ended, zf = search.replay(
                *search.window(S, Q), [(q["Z"], q["rem"]) for q in a["probes"]])
            m += int(not ended or zf != a["Z"])
            mism, bad = mism + m, bad or m > 0
        if i in pick:
            st = a["state"]
            e = recount.state_error(S, raw, st.S.double().cpu().numpy()[
                :K, :K], p.min_s_n_ratio)
            hq = st.h_max.double().cpu().numpy()[:K]
            e = max(e, float(np.max(np.abs(hq - h) / np.abs(h))))
            if np.any((st.Q.cpu().numpy()[:K, :K] != 0) != (Q != 0)):
                e = max(e, 1.0)
            err = max(err, e)
            bad = bad or e > limits["state_rel_err"]
        if i in pick_ub:
            Sc, Qc = scipy.sparse.csr_matrix(S), scipy.sparse.csr_matrix(Q)
            # The sketches' width, by the port's rule for this state.
            pad = make_alg(cfg, 0)._d_pad_for
            probes = [dict(q, D_pad=pad(a["state"], q["Z"])[0])
                      for q in a.get("probes", [])]
            g = pj.ub_gaps(mmw.s_tilde(Sc, Qc), mmw.assoc_edges(Qc), h, cfg,
                           probes, hooks, device)
            gaps += g
            bad = bad or max(g, default=0.0) > limits["ub_gap"]
        failed += int(bad)
    checks = {"state_rel_err": (err, limits["state_rel_err"]),
              "overload": (over, limits["overload"]),
              "broken": (broken, limits["broken"]),
              "rem_contradicted": (wrong, limits["rem_contradicted"]),
              "ub_gap": (max(gaps, default=0.0), limits["ub_gap"]),
              "search_mismatch": (mism, limits["search_mismatch"])}
    return checks, failed, n


def control_hooks(cfg: dict, what: str) -> dict:
    """The controls: ``"products"``, the reference's solve with its
    products one precision below the configuration's in the port's place;
    ``"state"``, the port's state with S and the budgets rounded to
    bfloat16, below the configuration's float32."""
    if what == "products":
        return {"ub_products": cfg["control_products"]}
    import dataclasses

    import torch

    def r(x):
        return x.to(torch.bfloat16).to(x.dtype)

    return {"state": lambda st: dataclasses.replace(st, S=r(st.S),
                                                    h_max=r(st.h_max))}
