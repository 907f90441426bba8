"""The large-scale deployment as the port serves it: the interference
graph made by the reference's generator from the seed, the port's ELL
state and block operands built from it, and its block-sparse MMW solver.

The benchmark hands the port the state ``(S, Q, h_max)`` a user of the
scheduler would hand it.  The judgement reads the port's answers and the
ELL state it built against the reference's float64 state.
"""

from __future__ import annotations

import time
import types

import numpy as np
import scipy.sparse

from portbench.harness import log
from portbench.reference import recount, roofline
from portbench.reference.state import large_state, params_of


def build(spec: dict, seed: int, device, hooks: dict):
    """A namespace with the reference state (``S``, ``Q``, ``h``), the
    port's ELL state ``ell`` and its prepared solver ``alg``.  The network
    comes from the workload's ``state_seed`` where it names one (every run
    solves the same deployment), else from the run's seed; the solver's
    and the rounding's draws always come from the run's seed."""
    import torch

    from sig_sdp_mmw_torch.core.ell import ell_from_scipy
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll

    cfg = spec["config_file"]
    sv, op = cfg["solver"], cfg["operands"]
    t = [time.perf_counter()]
    S, Q, h = large_state(params_of(cfg), cfg.get("network_seed", seed))
    # What the port is handed: the state itself, or what a control puts in
    # its place.
    given = hooks["state"](S, Q, h) if "state" in hooks else (S, Q, h)
    t.append(time.perf_counter())
    ell = ell_from_scipy(*given, device=device)
    t.append(time.perf_counter())
    alg = MMWEll(nit=sv["nit"], rank_radio=sv["rank_radio"], eta=sv["eta"],
                 seed=seed, use_bcsr=True, nattempt=sv["nattempt"],
                 rounding=sv["rounding"])
    alg.prepare(ell, given[0], given[1], h_max=given[2], block=op["block"],
                dtype=getattr(torch, op["dtype"]),
                store_transpose=op["store_transpose"],
                flat_group=op["flat_group"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    log(f"[portbench] set-up: state {t[1] - t[0]:.3f}s, ELL state "
        f"{t[2] - t[1]:.3f}s, block operands {t[3] - t[2]:.3f}s")
    lb, ub = ell.degree_bounds()
    return types.SimpleNamespace(S=S, Q=Q, h=h, given=given, ell=ell,
                                 alg=alg, lb=lb, ub=ub, cfg=cfg,
                                 counters={})


def port_verify(sysm, z) -> bool:
    """The port's own check of an answer, on the state it was handed."""
    from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_csr

    return bool(verify_assignment_csr(*sysm.given, z)[0])


def state_error(sysm) -> float:
    """Largest relative error of the port's ELL state against the
    reference's: the S̃ᵀ rows' gains (S without the diagonal and the
    association pairs), the budgets and the diagonal; 1.0 where the port
    holds another number of gains."""
    ell, S, Q = sysm.ell, sysm.S.tocsr(), sysm.Q.tocsr()
    K = ell.K
    cols = ell.st_cols.cpu().numpy()[:K].astype(np.int64)
    vals = ell.st_vals.float().cpu().numpy()[:K].astype(np.float64)
    nz = vals != 0
    rows = np.broadcast_to(np.arange(K)[:, None], cols.shape)[nz]
    cols, vals = cols[nz], vals[nz]
    ref = np.asarray(S[rows, cols]).ravel()
    coo = S.tocoo()
    keep = coo.row != coo.col
    qpat = np.asarray(Q[coo.row[keep], coo.col[keep]]).ravel() != 0
    n_ref = int(np.sum(~qpat))
    err = recount.state_error(ref, ref, vals, 0.0)
    if vals.size != n_ref:
        err = max(err, 1.0)
    for got, want in ((ell.h_max, sysm.h), (ell.diag_S, S.diagonal())):
        g = got.double().cpu().numpy()[:K]
        err = max(err, float(np.max(np.abs(g - want) / np.abs(want))))
    return err


def judge_answers(sysm, answers, limits: dict):
    """(checks, failed, n_judged): every answer recounted on the
    reference's state.  One that claims every user a slot (rem 0) has to
    keep the guarantees to the limits; one that claims users left over
    (rem > 0) may not be a schedule that keeps them (``rem_contradicted``).
    The port's own check (``port_ok``) compares loads in float64 with no
    room, below the float32 state's rounding, so it judges nothing: its
    rejections are reported
    (:func:`portbench.judge.port_rejected`)."""
    over, broken, wrong, failed, n = 0.0, 0, 0, 0, 0
    for a in answers:
        if a.get("error"):
            failed += 1
            continue
        o, b = recount.recount(sysm.S, sysm.Q, sysm.h, a["z"], a["Z"])
        n += 1
        if a["rem"] != 0:
            bad = o <= limits["overload"] and b <= limits["broken"]
            wrong += int(bad)
        else:
            over, broken = max(over, o), max(broken, b)
            bad = o > limits["overload"] or b > limits["broken"]
        failed += int(bad)
    checks = {"state_rel_err": (state_error(sysm), limits["state_rel_err"]),
              "overload": (over, limits["overload"]),
              "broken": (broken, limits["broken"]),
              "rem_contradicted": (wrong, limits["rem_contradicted"])}
    return checks, failed, n


def free(sysm):
    """Let go of the port's state and solver, and of the card's cache."""
    import torch

    sysm.alg = sysm.ell = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def spmm_bound_s(sysm, Z: int) -> float:
    """Least seconds of the SpMM work of one solve at ``Z`` slots
    (:mod:`portbench.reference.roofline`), from the reference state's real
    blocks."""
    if "blocks" not in sysm.counters:
        S, Q = sysm.S.tocsr(), sysm.Q.tocsr()
        St = S.transpose().tocsr()
        St = St - St.multiply(Q != 0)
        St.setdiag(0.0)
        St.eliminate_zeros()
        B = sysm.cfg["operands"]["block"]
        sysm.counters["blocks"] = {
            "St": roofline.real_blocks(St, B, B),
            "StT": roofline.real_blocks(St.transpose(), B, B),
            "Q": roofline.real_blocks(Q, B, B)}
    sv, op = sysm.cfg["solver"], sysm.cfg["operands"]
    prods = roofline.solve_products(sv["nit"], sv["eta"], Z,
                                    sv["rank_radio"])
    return roofline.solve_bound_s(sysm.counters["blocks"], op["block"],
                                  sysm.S.shape[0], op["dtype"], prods)


def control_hooks(cfg: dict, what: str) -> dict:
    """The controls: ``"products"``, the reference's solve with its
    products one precision below the configuration's operands in the
    port's place; ``"state"``, the state handed over in bfloat16, below
    the configuration's float32."""
    if what == "products":
        return {"ub_products": cfg["control_products"]}
    import torch

    def r(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).double().numpy()

    def bf16_state(S, Q, h):
        S2 = scipy.sparse.csr_matrix((r(S.data), S.indices, S.indptr),
                                     shape=S.shape)
        return S2, Q, r(h)

    return {"state": bf16_state}
