"""Runs of every cell on the CPU at a tiny size, through the harness with
its look for a card skipped: the result line, the metric readers, the
control and the faults each check has to catch.  The card's own run is
the ``cuda``-marked test at the end."""

from __future__ import annotations

import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.reference import recount, roofline
from portbench.reference.state import Params, dense_state, large_state

TINY = {"sig100k": dict(cell_size=12, nit=10),
        "sig300": dict(cell_size=5, nit=20)}
CELLS = ["sig100k.search", "sig300.schedule"]
CHECKS = {"state_rel_err", "overload", "broken", "rem_contradicted",
          "ub_gap", "search_mismatch"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_spec(name, nit=None):
    """The cell at a tiny size (``nit``: the solver's depth, default the
    tiny one)."""
    spec = copy.deepcopy(harness.cell_spec(name))
    t = TINY[spec["config"]]
    spec["config_file"]["scenario"]["cell_size"] = t["cell_size"]
    spec["config_file"]["solver"]["nit"] = nit or t["nit"]
    return spec


def run(name, trace=False, hooks=None, seconds=1.0, seed=2**31 + 5):
    return harness.run_cell(name, seed, seconds, trace, device="cpu",
                            spec=tiny_spec(name), hooks=hooks)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    r = run(name, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(r)[:len(keys)] == keys and list(r)[-1] == "checks"
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["checks"]) == CHECKS and r["failed"] == 0
    spec = harness.cell_spec(name)
    group = spec["per_layer" if trace else "end_to_end"]
    # The CPU has no device trace: the device metrics stay silent there.
    want = {m["name"] for m in group if m["source"] != "device_trace"}
    assert want <= set(r["metrics"])
    for m in r["metrics"].values():
        assert np.isfinite(m["value"]) and m["value"] > 0
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _assoc_pair(Q):
    import scipy.sparse

    c = scipy.sparse.coo_matrix(Q)
    k = int(np.argmax(c.row < c.col))
    return int(c.row[k]), int(c.col[k])


def _faults(name):
    """The faults this cell can have, each as hooks that plant it."""
    def share_slot(z, Z):          # an answer altered where it is made
        z = np.array(z)
        i, j = fault_pair["ij"]
        z[j] = z[i]
        return z

    def half_left_out(z, Z):       # half of the users left without a slot
        z = np.array(z)
        z[::2] = -1
        return z

    def stale(solve):              # the solve hands back its first factor
        first = []

        def again(it, Z, state):
            if not first:
                first.append(solve(it, Z, state))
            return first[0]

        return again

    fault_pair = {}
    out = {"altered": {"answer": share_slot},
           "half": {"answer": half_left_out},
           "stale": {"solve": stale}}
    spec = tiny_spec(name)
    from portbench.reference.state import params_of
    p = params_of(spec["config_file"])
    if spec["config_file"]["system"] == "large":
        fault_pair["ij"] = _assoc_pair(large_state(p, 2**31 + 5)[1])
    else:
        stale = {}

        def unchanged(st):         # the env hands back its first state
            return stale.setdefault("st", st)

        out["unchanged"] = {"state": unchanged}
        seen = {}

        def share_slot_dense(z, Z):
            # users of one AP in the first network the cell draws
            if "ij" not in seen:
                q = seen["q"]
                seen["ij"] = _assoc_pair(q)
            z = np.array(z)
            i, j = seen["ij"]
            z[j] = z[i]
            return z

        from portbench.reference.users import draw_users
        index = 0
        seen["q"] = dense_state(p, draw_users(p.n_sta, p.grid_edge,
                                              2**31 + 5, index)[0])[1]
        out["altered"] = {"answer": share_slot_dense}
    return out


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in ("altered", "half", "stale", "unchanged")
    if not (f == "unchanged" and n.startswith("sig100k"))])
def test_fault_comes_out_not_correct(name, fault):
    """Each fault the cell can have, planted under the timed path, makes
    ``correct`` false (sig100k's state is built once in set-up, so it has
    no state to leave unchanged between requests)."""
    r = run(name, hooks=_faults(name)[fault], seconds=4.0)
    assert r["attempted"] >= 2
    assert not r["correct"], r["checks"]


def spec_nit(name):
    return harness.cell_spec(name)["config_file"]["solver"]["nit"]


def _first_search_only(solve):
    """A ``solve`` hook that closes the window when the next search begins
    (its first probe comes again), so the window holds one whole search."""
    first = []

    def f(it, Z, state):
        if first and Z == first[0]:
            raise harness.StopWindow
        first.append(Z)
        return solve(it, Z, state)

    return f


@pytest.mark.parametrize("name", CELLS)
def test_control_products_comes_out_not_correct(name):
    """The reference's solve with its products one precision below the
    configuration's, in the port's place: the bound's gap fails.  At the
    configuration's own depth (150 iterations), on a tiny network.  What
    the window holds does not depend on the CPU's speed: one request of
    the dense cell (at K=75 the control's gap ranges from under the limit
    to 14 times it from network to network; PERF.md §2), one whole search
    of the 100k cell, down to the probes next to the answer, where the
    products' precision shows."""
    spec = tiny_spec(name, nit=spec_nit(name))
    hooks = control.hooks_for(spec, "products")
    seconds = 0.01
    if spec["config"] == "sig100k":
        spec["config_file"]["scenario"]["cell_size"] = 8
        hooks["solve"] = _first_search_only
        seconds = 600.0
    r = harness.run_cell(name, 3, seconds, False, device="cpu", spec=spec,
                         hooks=hooks)
    assert not r["correct"]
    c = r["checks"]["ub_gap"]
    assert c["value"] > c["limit"], c


@pytest.mark.parametrize("name", CELLS)
def test_control_state_comes_out_not_correct(name):
    """The state in bfloat16, the precision below the configurations'."""
    spec = tiny_spec(name)
    r = harness.run_cell(name, 3, 1.0, False, device="cpu", spec=spec,
                         hooks=control.hooks_for(spec, "state"))
    assert not r["correct"]
    assert r["checks"]["state_rel_err"]["value"] > 1e-3


def test_search_replay():
    """The reference's bisection: the probes it has to make and the Z it
    has to return, and a departure from either counted."""
    from portbench.judge import search_mismatches
    from portbench.reference.search import replay

    # window [10, 20]: 15 ok -> [10, 15]: 12 no -> [13, 15]: 14 ok ->
    # [13, 14]: 13 ok, closed -> Z 13
    probes = [(15, 0), (12, 3), (14, 0), (13, 0)]
    assert replay(10, 20, probes) == (0, True, 13)
    assert replay(10, 20, probes[:2]) == (0, False, None)
    assert replay(10, 20, [(16, 0)] + probes[1:])[0] >= 1
    two = probes + probes[:2]
    assert search_mismatches(10, 20, two, [(13, 0)]) == 0
    assert search_mismatches(10, 20, two, [(14, 0)]) == 1
    assert search_mismatches(10, 20, two, []) == 1       # never returned
    # the window closed on the last probe, before the search returned
    assert search_mismatches(10, 20, probes, []) == 0
    assert search_mismatches(10, 20, probes, [(13, 0), (13, 0)]) == 1


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "sig300.schedule", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_script_without_card_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run the cell")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "sig300.schedule", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_no_jax():
    code = ("import sys; from portbench.tests.test_portbench_runs import run;"
            " run('sig300.schedule'); from portbench import harness;"
            " assert not harness.check_no_jax(), harness.check_no_jax()")
    subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                   check=True, timeout=300)


def test_reference_generator_is_the_ports():
    """The frozen copies agree with the port's generators at small sizes."""
    from sig_sdp_mmw_torch.env.env import WirelessEnv
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr

    p = Params(12, 75e-4)
    S, Q, h = large_state(p, 9)
    S2, Q2, h2 = generate_large_state_csr(12, 75e-4, seed=9,
                                          backend="python")
    assert abs(S - S2).max() == 0 and abs(Q - Q2).max() == 0
    assert np.array_equal(h, h2)
    p = Params(10, 75e-4)
    locs = np.random.default_rng(4).uniform(0, p.grid_edge, (p.n_sta, 2))
    st = WirelessEnv(cell_size=10, sta_density_per_1m2=75e-4,
                     sta_locs=locs, device="cpu").generate_S_Q_hmax()
    S, Q, h, raw = dense_state(p, locs)
    K = p.n_sta
    assert recount.state_error(S, raw, st.S.numpy()[:K, :K], 0.1) < 1e-6
    assert np.array_equal(st.Q.numpy()[:K, :K] != 0, Q != 0)


def test_recount():
    S = np.array([[2.0, 0.5, 0.3], [0.4, 2.0, 0.0], [0.2, 0.1, 2.0]])
    Q = np.array([[0, 0, 1], [0, 0, 0], [1, 0, 0.0]])
    h = np.array([1.0, 0.45, 1.0])
    assert recount.recount(S, Q, h, [0, 1, 1], 2) == (0.0, 0)
    over, broken = recount.recount(S, Q, h, [0, 0, 1], 2)
    assert over == pytest.approx((0.5 - 0.45) / 0.45) and broken == 0
    assert recount.recount(S, Q, h, [0, 1, 0], 2)[1] == 1
    assert recount.recount(S, Q, h, [0, 1, 2], 2)[1] == 1


def test_answers_judged_by_the_recount_not_the_ports_check(monkeypatch):
    """A schedule whose loads pass their budgets by float32 rounding, which
    the port's own float64 check rejects, is correct and reported; one
    past the overload limit, or with a user outside [0, Z), fails."""
    import types

    from portbench import judge as pj
    from portbench.systems import large

    S = np.array([[2.0, 0.5, 0.3], [0.4, 2.0, 0.0], [0.2, 0.1, 2.0]])
    Q = np.zeros((3, 3))
    limits = {"overload": 1e-5, "broken": 0, "state_rel_err": 1e-4,
              "rem_contradicted": 0}
    monkeypatch.setattr(large, "state_error", lambda sysm: 0.0)

    def failed(h, z, Z=2):
        sysm = types.SimpleNamespace(S=S, Q=Q, h=np.asarray(h))
        ans = [{"index": 0, "Z": Z, "rem": 0, "z": z, "port_ok": False}]
        assert pj.port_rejected(ans) == [0]
        checks, f, n = large.judge_answers(sysm, ans, limits)
        assert n == 1
        return f

    assert failed([1.0, 0.5 / (1 + 3e-8), 1.0], [0, 0, 1]) == 0
    assert failed([1.0, 0.5 / (1 + 2e-5), 1.0], [0, 0, 1]) == 1
    assert failed([1.0, 1.0, 1.0], [0, 0, 2]) == 1


def test_roofline_counts_the_ports_real_blocks():
    """Real blocks from the pattern equal the stored real slots of the
    port's operands; the bound is the larger of bytes and operations."""
    from sig_sdp_mmw_torch.experiments.bench_flat_spmm import real_slots
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state

    S, Q, h = large_state(Params(12, 75e-4), 1)
    ops = bcsr_operands_from_state(S, Q, block=128, dtype=torch.bfloat16,
                                   store_transpose=True, flat_group=8)
    St = S.transpose().tocsr()
    St = St - St.multiply(Q != 0)
    St.setdiag(0.0)
    St.eliminate_zeros()
    assert roofline.real_blocks(St, 128, 128) == int(
        real_slots(ops.s_flat).sum())
    assert roofline.real_blocks(St.T, 128, 128) == int(
        real_slots(ops.st_flat).sum())
    t = roofline.product_bound_s(10, 128, 128, 1024, 1024, 32, "bfloat16")
    assert t == pytest.approx(max((10 * 128 * 128 * 2 + 2048 * 32 * 4)
                                  / 3.35e12,
                                  2 * 10 * 128 * 128 * 32 / 989e12))
    prods = roofline.solve_products(150, 0.05, 17, 2)
    assert prods[0] == ("St", 34, 150 * 11)   # Lanczos depth 10, +1


def test_readers_on_a_synthetic_trace():
    from portbench import readers

    rec = {"trace": {"busy": [[0.0, 1.0], [2.0, 3.0]],
                     "kernels": [("k", 0.0, 1.0), ("k", 2.0, 3.0)],
                     "host": [("pb.solve", 0.5, 2.5)],
                     "busy_s": 2.0, "window_s": 4.0}}
    assert readers.busy_within(rec, [(0.5, 2.5)]) == pytest.approx(1.0)
    assert readers.kernels_within(rec, [(0.5, 2.5)]) == 1
    assert readers.idle_pct(rec) == pytest.approx(50.0)
    rec["trace"]["busy_s"] = 0.0
    assert readers.idle_pct(rec) is None
    assert harness.merge([(0, 1), (0.5, 2), (3, 4)]) == [[0, 2], [3, 4]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """A short run of each cell at its own size on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run_cell(name, 2**31 + 77, 2.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu", r["checks"]
