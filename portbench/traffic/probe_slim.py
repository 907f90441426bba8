"""Protocol ``probe_slim``: the ``probe`` protocol's feasibility checks of
the binary search on the million-link deployment's slim state
(:mod:`portbench.systems.slim`).

The window is the ``probe`` protocol's (:func:`portbench.traffic.probe.
window`): the port's ``BinarySearchRelaxation.run`` with ``MMWEll`` on the
slim state from the degree window, a request per probe (a solve at Z, the
host rounding, the port's verification), a new search whenever one ends.
Set-up builds the slim state and the block operands, then one short solve
(``warm_nit`` iterations) and one rounding at the search's first Z.

The judgement recounts every answer and replays the searches as ``probe``
does.  ``ub_gap`` solves again in the reference only the probe at the
smallest Z (a float64 solve at a million links takes about 35 s on the
card), after the port's state is freed, and reads the bound by its parts
(:mod:`portbench.reference.ub_parts`): the largest of the bound's gap and
the gaps of the worst violation of each constraint block.  The search's
first probes lie far above the answer, where the bound is the association
or the diagonal part and barely moves with the products' precision; the
budgets' part reads every product of S̃ there.
"""

from __future__ import annotations

import math
import time

from portbench import judge as pj
from portbench.harness import log
from portbench.reference import mmw, search
from portbench.reference.roofline import solve_products
from portbench.reference.ub_parts import ub_parts
from portbench.systems import slim
from portbench.traffic.probe import port_solve, sample, window  # noqa: F401


def _with_parts(solve, c):
    """The port's solve, each solve's bound parts kept by its draws'
    stream (the ``stream`` its answer records)."""
    def run(it, Z, state):
        out = solve(it, Z, state)
        c.parts[c.alg._ncall] = c.alg.last_output.ub_parts.tolist()
        return out

    return run


def setup(spec, seed, device, tracer, hooks):
    c = slim.build(spec, seed, device, hooks)
    c.tracer, c.hooks, c.spec, c.seed = tracer, hooks, spec, seed
    alg = c.alg
    t0 = time.perf_counter()
    Z0 = (c.lb + c.ub) // 2            # the search's first probe
    alg.nit = int(spec["workload"]["warm_nit"])
    _, gX = alg.run_with_state(-1, Z0, c.ell)
    alg.rounding(Z0, gX, c.ell)
    alg.nit = spec["config_file"]["solver"]["nit"]
    log(f"[portbench] K={c.ell.K} lb={c.lb} ub={c.ub}; warm solve and "
        f"rounding at Z={Z0} {time.perf_counter() - t0:.3f}s")
    c.searches, c.parts = [], {}
    c.solve = hooks.get("solve", lambda f: f)(
        _with_parts(port_solve(alg), c))
    return c


def ub_gaps(c, probes, device) -> list:
    """Each probe's largest |port - reference| of the bound and of its
    three parts, the reference solving again with the same sketches and
    the configuration's ``reference_products``; the control's
    ``ub_products`` puts the reference at a lower precision in the port's
    place.  A probe whose parts the port did not report reads inf."""
    sv, cfg = c.cfg["solver"], c.cfg
    edges = mmw.assoc_edges(c.Q)
    out = []
    for a in probes:
        kw = dict(nit=sv["nit"], eta=sv["eta"], rank_radio=sv["rank_radio"],
                  Kp=a["Kp"], D_pad=a["D_pad"], seed=a["seed"],
                  stream=a["stream"], device=device)
        ref = ub_parts(c.St, edges, c.h, a["Z"],
                       low=cfg["reference_products"], **kw)
        if "ub_products" in c.hooks:
            got = ub_parts(c.St, edges, c.h, a["Z"],
                           low=c.hooks["ub_products"], **kw)
            ub = max(got)
        else:
            got, ub = c.parts.get(a["stream"]), a["ub"]
        if got is None:
            out.append(math.inf)
            continue
        out.append(max([abs(ub - max(ref))]
                       + [0.0 if g == w else abs(g - w)
                          for g, w in zip(got, ref)]))
    return out


def judge(c, answers):
    from sig_sdp_mmw_torch.ops import bcsr

    t0 = time.perf_counter()
    limits = c.spec["workload"]["checks"]
    c.St = mmw.s_tilde(c.S, c.Q)
    c.St.sort_indices()
    checks, failed, n = slim.judge_answers(c, answers, limits)
    launched = {name: {r: now.get(r, 0) - then.get(r, 0) for r in now}
                for name, now, then in (
                    ("bsr_spmm_flat", bcsr.bsr_spmm_flat.route_launches,
                     c.launch0[0]),
                    ("bcsr_spmm", bcsr.bcsr_spmm.route_launches,
                     c.launch0[1]))}
    device = c.ell.mask.device
    c.solve = None                    # holds the solver
    slim.free(c)                      # the reference runs in its place
    picked = sample(answers, c.seed)[:1]
    gaps = ub_gaps(c, picked, device)
    failed += sum(int(g > limits["ub_gap"]) for g in gaps)
    checks["ub_gap"] = (max(gaps, default=0.0), limits["ub_gap"])
    lo, hi = search.window(c.S, c.Q)
    probes = [(a["Z"], a["rem"]) for a in answers if "Z" in a]
    bad = pj.search_mismatches(lo, hi, probes, c.searches)
    checks["search_mismatch"] = (bad, limits["search_mismatch"])
    if c.tracer.on:
        c.counters["bound_s"] = [slim.spmm_bound_s(c, a["Z"])
                                 if "Z" in a else None for a in answers]
        log(f"[portbench] real 128x128 blocks {c.counters['blocks']}")
    sv = c.cfg["solver"]
    products = {}
    for a in answers:
        for name, _, k in solve_products(sv["nit"], sv["eta"],
                                         a.get("Z", 0), sv["rank_radio"]):
            products[name] = products.get(name, 0) + k * ("Z" in a)
    log(f"[portbench] SpMM products of the window's solves (reference "
        f"count) {products}; the port's kernel launches {launched}")
    c.counters["nit"] = sv["nit"]
    judge_s = time.perf_counter() - t0
    log(f"[portbench] judgement {judge_s:.3f}s")
    info = {"lb": c.lb, "ub": c.ub,
            "probe_Z": [a.get("Z") for a in answers],
            "rem": [a.get("rem") for a in answers],
            "solver_ub": [round(a["ub"], 4) for a in answers if "ub" in a],
            "searches": c.searches, "judged": n, "launches": launched,
            "port_rejected": pj.port_rejected(answers),
            "ub_checked": [[a["Z"], g] for a, g in zip(picked, gaps)],
            "ub_parts": [[x if math.isfinite(x) else None for x in
                          c.parts.get(a["stream"], [])] for a in picked],
            "judge_s": judge_s}
    return {"checks": checks, "failed": failed, "info": info}
