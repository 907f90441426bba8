"""Judgements that the protocols share: the solver's bound held against
the reference's solve, the searches held against the reference's
bisection, and the answers the port's own check rejects."""

from __future__ import annotations

from portbench.reference import mmw, search


def ub_gaps(St, edges, h, cfg: dict, probes, hooks: dict, device) -> list:
    """|ub of the port - ub of the reference| of each probe in ``probes``
    (records holding ``Z``, ``ub`` and the sketches' ``seed``, ``stream``,
    ``Kp``, ``D_pad``): the reference solves again on its own state
    (S̃ ``St``, association ``edges``, budgets ``h``) with the same
    sketches, its products at the configuration's ``reference_products``
    precision (None: float64).  The control's ``ub_products`` hook puts
    the reference at a lower precision in the port's place."""
    sv = cfg["solver"]
    out = []
    for a in probes:
        kw = dict(nit=sv["nit"], eta=sv["eta"], rank_radio=sv["rank_radio"],
                  Kp=a["Kp"], D_pad=a["D_pad"], seed=a["seed"],
                  stream=a["stream"], device=device)
        ref = mmw.ub_final(St, edges, h, a["Z"],
                           low=cfg["reference_products"], **kw)
        got = (mmw.ub_final(St, edges, h, a["Z"], low=hooks["ub_products"],
                            **kw)
               if "ub_products" in hooks else a["ub"])
        out.append(abs(got - ref))
    return out


def search_mismatches(lo: int, hi: int, probes: list, finished: list) -> int:
    """Probes and returned Z of consecutive searches (``probes``: (Z, rem)
    in order; ``finished``: (Z, rem) each search returned) that differ
    from what the reference's bisection over the same answers had to probe
    and return.  The window may close on a search's last probe, before
    the search returns."""
    bad, start, k = 0, 0, 0
    for n in range(len(probes)):
        b, done, zf = search.replay(lo, hi, probes[start:n + 1])
        if done:
            if k < len(finished):
                bad += b + int(finished[k][0] != zf)
            else:
                # No return: right only where the window closed on this
                # search's last probe, before the search could return.
                bad += b + int(n < len(probes) - 1)
            k, start = k + 1, n + 1
    bad += search.replay(lo, hi, probes[start:])[0]
    return bad + max(0, len(finished) - k)


def port_rejected(answers) -> list:
    """Indices of the answers that claim every user a slot and that the
    port's own check rejects.  That check compares each load with its
    budget in float64 with no room, below the float32 state's rounding, so
    it is reported, not judged: the reference's recount judges."""
    return [a["index"] for a in answers
            if not a.get("error") and not a["port_ok"]]
