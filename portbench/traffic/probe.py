"""Protocol ``probe``: feasibility checks of the binary search at scale.

One client, a closed loop.  The window runs the port's
``BinarySearchRelaxation.run`` with its block-sparse ``MMWEll`` as the
feasibility check on the cell's state, starting again from the degree
bounds whenever a search ends.  A request is one probe: a solve at Z, the
rounding and the port's own verification of the answer.  An infeasible Z
is an answer, not a failure.  The network is the configuration's
(``network_seed``); the draws come from the run's seed.

Set-up: the state, the port's ELL state and block operands,
then one short solve (``warm_nit`` iterations) and one rounding at the
search's first Z, which builds and loads every kernel the window runs.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import judge as pj
from portbench.harness import StopWindow, log
from portbench.reference import mmw, search
from portbench.reference.roofline import solve_products
from portbench.systems import large


class _Probe:
    """The feasibility check the search calls: the port's solver, timed by
    spans, each answer handed to the window."""

    def __init__(self, ctx, win):
        self.ctx, self.win = ctx, win

    def run_with_state(self, it, Z, state):
        alg = self.ctx.alg
        with self.ctx.tracer.span("pb.solve"):
            ok, gX, ub = self.ctx.solve(it, Z, state)
        # The bound, and what the solve drew its sketches as.
        self.solved = {"ub": ub, "seed": self.ctx.seed,
                       "stream": alg._ncall, "Kp": state.Kp,
                       "D_pad": alg._pinned[1]}
        return ok, gX

    def rounding(self, Z, gX, state):
        c = self.ctx
        with c.tracer.span("pb.rounding"):
            z, Zr, rem = c.alg.rounding(Z, gX, state)
        with c.tracer.span("pb.verify"):
            ok = large.port_verify(c, z)
        z = c.hooks.get("answer", lambda z, Z: z)(z, Z)
        self.win.answer(dict(self.solved, Z=int(Z), rem=int(rem), z=z,
                             port_ok=ok or rem != 0))
        return z, Zr, rem


def port_solve(alg):
    """The port's solve, with the bound it reports."""
    def solve(it, Z, state):
        ok, gX = alg.run_with_state(it, Z, state)
        return ok, gX, float(alg.last_output.ub_final)

    return solve


def setup(spec, seed, device, tracer, hooks):
    c = large.build(spec, seed, device, hooks)
    c.tracer, c.hooks, c.spec, c.seed = tracer, hooks, spec, seed
    wl = spec["workload"]
    alg = c.alg
    t0 = time.perf_counter()
    Z0 = (c.lb + c.ub) // 2            # the search's first probe
    alg.nit = int(wl["warm_nit"])
    _, gX = alg.run_with_state(-1, Z0, c.ell)
    alg.rounding(Z0, gX, c.ell)
    alg.nit = spec["config_file"]["solver"]["nit"]
    log(f"[portbench] K={c.ell.K} lb={c.lb} ub={c.ub}; warm solve and "
        f"rounding at Z={Z0} {time.perf_counter() - t0:.3f}s")
    c.searches = []
    c.solve = hooks.get("solve", lambda f: f)(port_solve(alg))
    return c


def window(c, win):
    from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation
    from sig_sdp_mmw_torch.ops import bcsr

    c.launch0 = (dict(bcsr.bsr_spmm_flat.route_launches),
                 dict(bcsr.bcsr_spmm.route_launches))
    while True:
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = _Probe(c, win)
        try:
            _, Z, rem = bs.run(c.ell)
            c.searches.append([int(Z), int(rem)])
        except StopWindow:
            raise
        except Exception as e:           # the request in flight failed
            win.answer({"error": repr(e)})


def sample(answers, seed: int) -> list:
    """The probes whose bound the reference solves again: the first at the
    smallest Z, next to the answer, where the products' precision shows
    most, and one more drawn from the seed."""
    done = [a for a in answers if "ub" in a]
    if not done:
        return []
    nearest = min(done, key=lambda a: a["Z"])
    rng = np.random.default_rng([int(seed), 11])
    other = done[int(rng.integers(len(done)))]
    return [nearest] + ([other] if other is not nearest else [])


def judge(c, answers):
    from sig_sdp_mmw_torch.ops import bcsr

    limits = c.spec["workload"]["checks"]
    checks, failed, n = large.judge_answers(c, answers, limits)
    launched = {name: {r: now.get(r, 0) - then.get(r, 0) for r in now}
                for name, now, then in (
                    ("bsr_spmm_flat", bcsr.bsr_spmm_flat.route_launches,
                     c.launch0[0]),
                    ("bcsr_spmm", bcsr.bcsr_spmm.route_launches,
                     c.launch0[1]))}
    device = c.ell.mask.device
    large.free(c)                     # the reference runs in its place
    picked = sample(answers, c.seed)
    gaps = pj.ub_gaps(mmw.s_tilde(c.S, c.Q), mmw.assoc_edges(c.Q), c.h,
                      c.cfg, picked, c.hooks, device)
    for a, g in zip(picked, gaps):
        failed += int(g > limits["ub_gap"])
    checks["ub_gap"] = (max(gaps, default=0.0), limits["ub_gap"])
    lo, hi = search.window(c.S, c.Q)
    probes = [(a["Z"], a["rem"]) for a in answers if "Z" in a]
    bad = pj.search_mismatches(lo, hi, probes, c.searches)
    checks["search_mismatch"] = (bad, limits["search_mismatch"])
    if c.tracer.on:
        c.counters["bound_s"] = [large.spmm_bound_s(c, a["Z"])
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
    c.counters["nit"] = c.cfg["solver"]["nit"]
    info = {"lb": c.lb, "ub": c.ub,
            "probe_Z": [a.get("Z") for a in answers],
            "rem": [a.get("rem") for a in answers],
            "solver_ub": [round(a["ub"], 4) for a in answers if "ub" in a],
            "searches": c.searches, "judged": n, "launches": launched,
            "port_rejected": pj.port_rejected(answers),
            "ub_checked": [[a["Z"], g] for a, g in zip(picked, gaps)]}
    return {"checks": checks, "failed": failed, "info": info}

