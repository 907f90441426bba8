"""The million-link deployment as the port serves it: the interference
graph made by the reference's generator at the configuration, the port's
slim state (the [Kp] and [E_pad] vectors, no O(K*deg) arrays on the
device) and block operands built from it, and its block-sparse MMW solver
with the rounding on the host (the Gram on the pattern's edges, the route
the solver picks where its block accumulator would pass 2 GiB).

The port's own check (``large.port_verify``, which the ``probe``
protocol's requests call), the freeing before the judgement, the controls
and the SpMM bound are the large-scale deployment's
(:mod:`portbench.systems.large`).  The judgement reads the slim state and
the block values against the reference's float64 state.
"""

from __future__ import annotations

import time
import types

import numpy as np

from portbench.harness import log
from portbench.reference import mmw, recount
from portbench.reference.state import large_state, params_of
from portbench.systems.large import (control_hooks, free,  # noqa: F401
                                     spmm_bound_s)


def build(spec: dict, seed: int, device, hooks: dict):
    """A namespace with the reference state (``S``, ``Q``, ``h``), the
    port's slim state ``ell`` (rows padded to the block size) and its
    prepared solver ``alg``.  The network is the configuration's
    ``network_seed``; the solver's and the rounding's draws come from the
    run's seed."""
    import torch

    from sig_sdp_mmw_torch.core.ell import EllSlim, ell_slim_from_csr
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll, MMWEllOutput

    # A program whose slim state keeps no search bounds, or whose solve
    # reports no parts of its bound, cannot run the cell: refuse it before
    # the minute the state takes.
    if not (hasattr(EllSlim, "degree_bounds")
            and "ub_parts" in MMWEllOutput.__dataclass_fields__):
        raise RuntimeError("the port's EllSlim has no degree_bounds or its "
                           "MMWEllOutput no ub_parts: it cannot run the "
                           "slim deployment's search")
    cfg = spec["config_file"]
    sv, op = cfg["solver"], cfg["operands"]
    alg = MMWEll(nit=sv["nit"], rank_radio=sv["rank_radio"], eta=sv["eta"],
                 seed=seed, use_bcsr=True, nattempt=sv["nattempt"],
                 rounding=sv["rounding"])
    t = [time.perf_counter()]
    S, Q, h = large_state(params_of(cfg), cfg.get("network_seed", seed))
    given = hooks["state"](S, Q, h) if "state" in hooks else (S, Q, h)
    t.append(time.perf_counter())
    B = op["block"]
    Kp = -(-S.shape[0] // B) * B
    ell = ell_slim_from_csr(*given, pad_rows_to=Kp, device=device)
    t.append(time.perf_counter())
    alg.prepare(ell, given[0], given[1], h_max=given[2], block=B,
                dtype=getattr(torch, op["dtype"]),
                store_transpose=op["store_transpose"],
                weights_dtype=getattr(torch, op["weights_dtype"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    log(f"[portbench] set-up: state {t[1] - t[0]:.3f}s, slim state "
        f"{t[2] - t[1]:.3f}s, block operands and host rounding state "
        f"{t[3] - t[2]:.3f}s")
    lb, ub = ell.degree_bounds()
    return types.SimpleNamespace(S=S, Q=Q, h=h, given=given, ell=ell,
                                 alg=alg, lb=lb, ub=ub, cfg=cfg,
                                 counters={})


def _rel(got, want) -> float:
    """Largest |got - want| / |want|; 1.0 where want is 0 and got is not."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    nz = want != 0
    err = np.where(nz, d / np.where(nz, np.abs(want), 1.0), d > 0)
    return float(np.max(err, initial=0.0))


def state_error(sysm) -> float:
    """Largest relative error of the port's slim state and block values
    against the reference's float64 state: S̃'s row sums and squared row
    sums and the budgets; the association edges (1.0 where one differs);
    the stored blocks' values, in S̃'s order, against the reference's S̃
    rounded to float32 and then to the blocks' bfloat16 (1.0 where the
    port holds another number of them)."""
    import torch

    ell, ops = sysm.ell, sysm.alg.bcsr
    St, K = sysm.St, ell.K
    err = 0.0
    for got, want in ((ell.S_sum, St.sum(axis=1)),
                      (ell.row2, St.multiply(St).sum(axis=1)),
                      (ell.h_max, sysm.h)):
        err = max(err, _rel(got[:K].double().cpu().numpy(),
                            np.asarray(want).ravel()))
    ai, aj = mmw.assoc_edges(sysm.Q)
    m = ell.a_mask.cpu().numpy()
    got = (ell.a_i.cpu().numpy()[m].astype(np.int64) * K
           + ell.a_j.cpu().numpy()[m])
    if not np.array_equal(np.sort(got), np.sort(ai * K + aj)):
        err = max(err, 1.0)
    vals = ops.s_blocks.blocks.reshape(-1)[ops.s_pos.long()]
    nreal = int(torch.count_nonzero(ops.s_blocks.blocks))
    want = torch.from_numpy(St.data.astype(np.float32)).to(
        ops.s_blocks.blocks.dtype).double().numpy()
    if vals.numel() != St.nnz or nreal != St.nnz:
        return max(err, 1.0)
    return max(err, _rel(vals.double().cpu().numpy(), want))


def judge_answers(sysm, answers, limits: dict):
    """(checks, failed, n_judged): every answer recounted on the
    reference's state, as :func:`portbench.systems.large.judge_answers`
    does it, and the slim state's error (``sysm.St``: the reference's S̃,
    indices sorted)."""
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
