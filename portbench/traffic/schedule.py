"""Protocol ``schedule``: one verified schedule for each fresh network.

One client, a closed loop: the journal's evaluation protocol, one network
after another.  Request i's users come from (seed, i); the port's
``WirelessEnv`` derives their state, then its ``BinarySearchRelaxation``
with a fresh dense ``MMW`` (seeded by the request) searches down to a
verified assignment.  An infeasible Z inside the search is an answer of
the search, not a failure.

Set-up: one short solve (``warm_nit`` iterations) and one rounding on the
network of ``WARM_INDEX``, which loads every library the window runs.
"""

from __future__ import annotations

import time
import types

from portbench import judge as pj
from portbench.harness import log
from portbench.reference.state import params_of
from portbench.reference.users import draw_users
from portbench.systems import dense

# The users of the warm-up, an index no request takes.
WARM_INDEX = 1 << 40


class _Probe:
    """The feasibility check the search calls: the port's solver, timed by
    spans; each probe's answer and what its solve drew its sketches as
    are kept for the judgement."""

    def __init__(self, c, win, alg):
        self.c, self.win, self.alg = c, win, alg
        self.solve = c.hooks.get("solve", lambda f: f)(port_solve(alg))
        self.log = []

    def run_with_state(self, it, Z, state):
        with self.c.tracer.span("pb.solve"):
            ok, gX, ub = self.solve(it, Z, state)
        self.solved = {"ub": ub, "seed": self.alg.seed,
                       "stream": self.alg._ncall, "Kp": state.Kp}
        return ok, gX

    def rounding(self, Z, gX, state):
        with self.c.tracer.span("pb.rounding"):
            z, Zr, rem = self.alg.rounding(Z, gX, state)
        self.log.append(dict(self.solved, Z=int(Z), rem=int(rem), z=z))
        self.c.probes += 1
        self.win.part()
        return z, Zr, rem


def port_solve(alg):
    """The port's solve, with the bound it reports."""
    def solve(it, Z, state):
        ok, gX = alg.run_with_state(it, Z, state)
        return ok, gX, float(alg.last_output.ub_final)

    return solve


def setup(spec, seed, device, tracer, hooks):
    cfg = spec["config_file"]
    p = params_of(cfg)
    c = types.SimpleNamespace(cfg=cfg, spec=spec, seed=seed, device=device,
                              tracer=tracer, hooks=hooks, p=p, counters={},
                              probes=0)
    t0 = time.perf_counter()
    st = dense.port_state(cfg, *draw_users(p.n_sta, p.grid_edge, seed, WARM_INDEX),
                          device, hooks)
    alg = dense.make_alg(cfg, seed)
    alg.nit = int(spec["workload"]["warm_nit"])
    lb, ub = st.degree_bounds()
    _, gX = alg.run_with_state(0, (lb + ub) // 2, st)
    alg.rounding((lb + ub) // 2, gX, st)
    log(f"[portbench] K={p.n_sta}; warm solve and rounding "
        f"{time.perf_counter() - t0:.3f}s")
    return c


def request(c, win, i):
    from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation

    locs, dirs = draw_users(c.p.n_sta, c.p.grid_edge, c.seed, i)
    with c.tracer.span("pb.env"):
        st = dense.port_state(c.cfg, locs, dirs, c.device, c.hooks)
    bs = BinarySearchRelaxation()
    probe = _Probe(c, win, dense.make_alg(c.cfg, c.seed * 1_000_003 + i))
    bs.feasibility_check_alg = probe
    z, Z, rem = bs.run(st)
    with c.tracer.span("pb.verify"):
        ok = dense.port_verify(st, z)
    z = c.hooks.get("answer", lambda z, Z: z)(z, Z)
    return {"Z": int(Z), "rem": int(rem), "z": z, "port_ok": ok or rem != 0,
            "state": st, "locs": locs, "users": i, "probes": probe.log}


def window(c, win):
    i = 0
    while True:
        try:
            ans = request(c, win, i)
        except Exception as e:
            ans = {"error": repr(e)}
        win.answer(ans, part=False)
        i += 1


def judge(c, answers):
    wl = c.spec["workload"]
    checks, failed, n = dense.judge_answers(
        c.cfg, answers, wl["checks"], int(wl["judge_sample"]), c.seed,
        c.hooks, c.device)
    c.counters["nit"] = c.cfg["solver"]["nit"]
    c.counters["probes"] = [len(a["probes"]) for a in answers
                            if "probes" in a]
    info = {"Z": [a.get("Z") for a in answers],
            "probes": c.counters["probes"], "judged": n,
            "port_rejected": pj.port_rejected(answers)}
    return {"checks": checks, "failed": failed, "info": info}
