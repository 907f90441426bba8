"""The port's profiling hooks (sig_sdp_mmw_torch.utils.profiling, the
counterpart of sig_sdp_mmw_tpu.utils.profiling): the cProfile decorator
behind its enabler, and the names ``annotate`` gives a ``device_trace``,
the sharded operator's spans among them; the span recorder: nothing
recorded or called while it is off, the program's spans, their nesting,
counts and attributes while a profiler runs, the record starting again
with each session, and the same bits either way.  No tolerances."""

import collections
import json
import time

import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.core.ell import ell_from_sig_state
from sig_sdp_mmw_torch.core.problem import state_from_arrays
from sig_sdp_mmw_torch.env.env import WirelessEnv
from sig_sdp_mmw_torch.env.large import generate_large_state_csr
from sig_sdp_mmw_torch.models import rounding_ell as trell
from sig_sdp_mmw_torch.models.mmw import MMW, mmw_default_lanczos_m
from sig_sdp_mmw_torch.models.mmw_ell import MMWEll, mmw_solve_ell
from sig_sdp_mmw_torch.models.rounding import verify_assignment
from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation
from sig_sdp_mmw_torch.parallel.mesh import MeshAxis
from sig_sdp_mmw_torch.utils import profiling
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.profiling import (GLOBAL_PROF_ENABLER, annotate,
                                               device_trace, profile)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while the module runs (parallel workers
    otherwise oversubscribe the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@profile
def _work(n):
    return sum(range(n))


def test_profile_respects_the_enabler(capsys):
    try:
        GLOBAL_PROF_ENABLER.DISABLE()
        assert _work(10) == 45
        assert capsys.readouterr().out == ""
        GLOBAL_PROF_ENABLER.ENABLE()
        assert _work(10) == 45
        assert "function calls" in capsys.readouterr().out
    finally:
        GLOBAL_PROF_ENABLER.ENABLE()


def _names(log_dir):
    with open(log_dir / "trace.json") as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_device_trace_holds_annotations(tmp_path):
    x = torch.ones(64, 64)
    with device_trace(str(tmp_path)) as prof:
        with annotate("phase.one"):
            y = x @ x
        with annotate("phase.two"):
            y = y + 1
    assert float(y[0, 0]) == 65.0
    assert {"phase.one", "phase.two"} <= _names(tmp_path)
    assert {"phase.one", "phase.two"} <= {e.key for e in prof.key_averages()}


def test_sharded_operator_names_its_products(tmp_path, mmw_small):
    st = state_from_arrays(mmw_small["S"], mmw_small["Q"], mmw_small["h_max"],
                           dtype=torch.float64)
    ell = ell_from_sig_state(st, dtype=np.float64)
    with device_trace(str(tmp_path)):
        out = mmw_solve_ell(ell, 8.0, nit=2, eta=0.05, D_pad=16, rank_pad=16,
                            draws=TorchDraws(0), graph=MeshAxis())
    assert np.isfinite(float(out.ub_final))
    names = _names(tmp_path)
    assert "graph.local_product" in names
    assert "graph.all_gather" not in names    # one rank gathers nothing


# ---- the span recorder ------------------------------------------------------

NIT, ETA = 2, 0.05


@pytest.fixture(scope="module")
def large():
    """A K=192 block-sparse state with its block operands built."""
    S, Q, h = generate_large_state_csr(8, 75e-4, seed=2)
    ell = tell.ell_from_scipy(S, Q, h)
    lb = int(np.diff(Q.indptr).max()) + 1
    return S, Q, h, ell, lb + 4


def _ell_alg(large, seed=0):
    S, Q, h, ell, _ = large
    alg = MMWEll(nit=NIT, eta=ETA, use_bcsr=True, seed=seed)
    return alg.prepare(ell, S, Q, h_max=h, block=128, flat_group=4)


@pytest.fixture(scope="module")
def dense():
    env = WirelessEnv(cell_size=5, sta_density_per_1m2=75e-4, seed=3,
                      device="cpu")
    return env.generate_S_Q_hmax()


def _ell_probe(large, seed=0):
    """One solve and one rounding of the block-sparse solver object."""
    _, _, _, ell, Z = large
    alg = _ell_alg(large, seed)
    _, X = alg.run_with_state(0, Z, ell)
    z, _, rem = alg.rounding(Z, X, ell, nattempt=3)
    return alg, X, z, rem


def _dense_probe(dense, seed=0):
    alg = MMW(nit=NIT, eta=ETA, seed=seed)
    lb, ub = dense.degree_bounds()
    _, X = alg.run_with_state(0, (lb + ub) // 2, dense)
    z, _, rem = alg.rounding((lb + ub) // 2, X, dense, nattempt=3)
    verify_assignment(dense, z)
    return alg, X, z, rem


def _raise(*a, **k):
    raise AssertionError("called with the recorder off")


@pytest.mark.parametrize("path", ["block", "dense"])
def test_off_path_records_and_calls_nothing(path, large, dense,
                                            monkeypatch):
    """No profiler, no tracing(): no span is recorded, and neither a
    profiler range, an NVTX range nor a timing event is made."""
    profiling.clear()
    for mod, name in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (torch.cuda, "Event"),
                      (torch.cuda.nvtx, "range_push")):
        monkeypatch.setattr(mod, name, _raise)
    if path == "block":
        _ell_probe(large)
    else:
        _dense_probe(dense)
    assert profiling.spans() == [] and profiling.dropped() == 0


class _FakeEvent:
    """A timing event on the host's clock, counted."""
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6


@pytest.mark.parametrize("path", ["block", "dense"])
def test_on_a_card_only_timed_spans_record_events(path, large, dense,
                                                  monkeypatch):
    """With CUDA initialised (faked), a span makes timing events only when
    opened with ``timed=True``: the re-orthogonalisation and the block
    factorisation, whose device time a reader takes from the record; the
    others read None there and leave their device time to the trace."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: 0)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling, "_events", [])
    monkeypatch.setattr(_FakeEvent, "made", 0)
    profiling.clear()
    with profiling.tracing():
        if path == "block":
            _ell_probe(large)
        else:
            _dense_probe(dense)
    recs = profiling.spans()
    timed = {"lanczos.reorth", "mmw_ell.factor"}
    assert recs and _FakeEvent.made == 2 * sum(s.name in timed
                                               for s in recs)
    for s in recs:
        if s.name in timed:
            assert 0 <= s.device_ms
        else:
            assert s.device_ms is None
    profiling.clear()


def _tree(recs):
    byid = {s.id: s for s in recs}
    kids = collections.defaultdict(list)
    for s in recs:
        kids[s.parent].append(s)
    return byid, kids


def _below(byid, s, top):
    while s.parent is not None:
        s = byid[s.parent]
        if s.id == top.id:
            return True
    return False


def test_block_solve_spans_nest_and_count_the_products(large, tmp_path):
    """One ``mmw_ell.solve`` (a root span, carrying ``last_solve``) holds
    nit iterations of its phases and ``mmw_ell.factor``; the products of
    the block operands are ``nit*(m+1) + 8`` of S̃ and ``nit*m + 8`` of
    S̃ᵀ and of Q, the counts ``solve_products`` prices; each iteration
    re-orthogonalises m times."""
    with device_trace(str(tmp_path)):
        alg, _, _, _ = _ell_probe(large)
    recs = profiling.spans()
    byid, kids = _tree(recs)
    solve, = [s for s in recs if s.name == "mmw_ell.solve"]
    assert solve.parent is None and solve.root == solve.id
    assert solve.attrs == alg.last_solve
    assert set(solve.attrs) == {"Z", "K", "D_pad", "rank_pad", "stream",
                                "nit", "gram_mode", "maxblk"}
    names = collections.Counter(s.name for s in kids[solve.id])
    phases = ("dual", "loss", "sketch", "expm", "primal", "gram")
    assert names == {**{f"mmw_ell.{p}": NIT for p in phases},
                     "mmw_ell.factor": 1}
    m = mmw_default_lanczos_m(ETA, NIT)
    spmm = [s for s in recs if s.name == "bcsr.spmm"]
    assert all(_below(byid, s, solve) for s in spmm)
    ops = collections.Counter(s.attrs["operand"] for s in spmm)
    assert ops == {"St": NIT * (m + 1) + 8, "StT": NIT * m + 8,
                   "Q": NIT * m + 8}
    assert {s.attrs["D"] for s in spmm} == {solve.attrs["D_pad"],
                                            solve.attrs["rank_pad"] + 8}
    expm = [s for s in kids[solve.id] if s.name == "mmw_ell.expm"]
    for e in expm:
        reorth = [s for s in recs if s.name == "lanczos.reorth"
                  and _below(byid, s, e)]
        assert len(reorth) == m
    for s in recs:
        assert s.t0 <= s.t1 and s.host_ms >= 0
        assert s.device_ms == s.host_ms          # no card: the host clock
        if s.parent is not None:
            p = byid[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1 and s.root == p.root


def test_dense_solve_and_rounding_spans(dense, tmp_path):
    """``mmw.solve`` holds nit of each dense phase and ``mmw.factor``;
    the rounding and the checker are spans of their own, with the
    attempts and the remainder."""
    with device_trace(str(tmp_path)):
        alg, _, _, rem = _dense_probe(dense)
    recs = profiling.spans()
    byid, kids = _tree(recs)
    solve, = [s for s in recs if s.name == "mmw.solve"]
    assert solve.parent is None and solve.attrs == alg.last_solve
    assert collections.Counter(s.name for s in kids[solve.id]) == {
        "mmw.dual": NIT, "mmw.loss": NIT, "mmw.expm": NIT,
        "mmw.primal": NIT, "mmw.factor": 1}
    m = mmw_default_lanczos_m(ETA, NIT)
    reorth = [s for s in recs if s.name == "lanczos.reorth"]
    assert len(reorth) == NIT * m
    assert all(byid[s.parent].name == "mmw.expm" for s in reorth)
    rnd, = [s for s in recs if s.name == "rounding.round"]
    assert rnd.attrs["attempts"] == 3 and rnd.attrs["rem"] == rem
    assert [s.name for s in recs if s.parent is None] == [
        "mmw.solve", "rounding.round", "rounding.verify"]


@pytest.mark.parametrize("route", ["batch", "sequential", "wavefront"])
def test_rounding_ell_spans_count_the_attempts(route, large, tmp_path,
                                               monkeypatch):
    """``rounding_ell.round`` carries the ``rounding_info`` record and
    the attempts run; the wavefront's attempts are its rounds' count, one
    ``rounding_ell.attempt`` span each."""
    if route != "batch":
        monkeypatch.setattr(trell, "_BATCH_ATTEMPT_MAX_KP", 0)
    if route == "wavefront":
        monkeypatch.setattr(trell, "_WAVEFRONT_MIN_KP", 0)
    _, _, _, ell, Z = large
    alg = _ell_alg(large)
    _, X = alg.run_with_state(0, Z - 3, ell)
    with device_trace(str(tmp_path)):
        _, _, rem = alg.rounding(Z - 3, X, ell, nattempt=4)
    info = alg.rounding_info[-1]
    rnd, = [s for s in profiling.spans() if s.name == "rounding_ell.round"]
    attempts = [s for s in profiling.spans()
                if s.name == "rounding_ell.attempt"]
    assert info["route"] == rnd.attrs["route"] == route
    assert rnd.attrs["rem"] == rem and rnd.attrs["Z_pad"] == info["Z_pad"]
    if route == "wavefront":
        assert rnd.attrs["attempts"] == len(info["rounds"]) == len(attempts)
        assert rnd.attrs["rounds"] == info["rounds"]
        assert [s.attrs["rem"] for s in attempts] == info["rems"]
    elif route == "batch":
        assert rnd.attrs["attempts"] == 4 and not attempts
    else:
        assert rnd.attrs["attempts"] == len(attempts) >= 1
    assert all(s.parent == rnd.id for s in attempts)


def test_search_spans_share_one_root(large, tmp_path):
    """Every span of a search is below its ``search.run``; one
    ``search.probe`` per probe, each holding one solve and one rounding,
    with the probe's window, Z and remainder."""
    _, _, _, ell, _ = large
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = _ell_alg(large)
    with device_trace(str(tmp_path)):
        _, Z, rem = bs.run(ell)
    recs = profiling.spans()
    run, = [s for s in recs if s.name == "search.run"]
    assert {s.root for s in recs} == {run.id}
    assert run.attrs["Z"] == Z and run.attrs["rem"] == rem
    probes = [s for s in recs if s.name == "search.probe"]
    table = bs.LOGGED_NP_DATA["bs_search_per_it"]
    assert len(probes) == run.attrs["it"] == len(table)
    byid, kids = _tree(recs)
    for p, row in zip(probes, table):
        assert p.parent == run.id
        assert [p.attrs[k] for k in ("lo", "hi", "mid", "Z", "rem")] == \
            list(row[3:8])
        assert [s.name for s in kids[p.id]] == ["mmw_ell.solve",
                                                "rounding_ell.round"]


def test_the_record_starts_again_with_each_session(dense, tmp_path):
    """One profiled window, one record: a second session, or spans asked
    for while off between two, start it again; tracing() records without
    a profiler; clear() empties it; past the cap spans are counted."""
    env = WirelessEnv(cell_size=5, sta_density_per_1m2=75e-4, seed=4,
                      device="cpu")
    with device_trace(str(tmp_path / "a")):
        env.generate_state()
    first = profiling.spans()
    assert [(s.name, s.attrs) for s in first] == [("env.state",
                                                   {"K": env.n_sta})]
    with device_trace(str(tmp_path / "b")):
        env.generate_state()
        env.generate_state()
    assert [s.name for s in profiling.spans()] == ["env.state"] * 2
    for _ in range(2):
        env.generate_state()                  # off: marks the record stale
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            env.generate_state()
        assert len(profiling.spans()) == 1
    with profiling.tracing():
        env.generate_state()
        with profiling.tracing():
            env.generate_state()
    assert len(profiling.spans()) == 2
    profiling.clear()
    assert profiling.spans() == []
    cap = profiling.MAX_SPANS
    try:
        profiling.MAX_SPANS = 1
        with profiling.tracing():
            for _ in range(3):
                env.generate_state()
        assert len(profiling.spans()) == 1 and profiling.dropped() == 2
    finally:
        profiling.MAX_SPANS = cap
        profiling.clear()


@pytest.mark.parametrize("path", ["block", "dense"])
def test_tracing_leaves_the_bits_alone(path, large, dense, tmp_path):
    """``X_half``, ``ub_final`` and the assignment are the same bits with
    the recorder on and off."""
    probe = ((lambda: _ell_probe(large, seed=7)) if path == "block"
             else (lambda: _dense_probe(dense, seed=7)))
    off = probe()
    with device_trace(str(tmp_path)):
        on = probe()
    assert profiling.spans()
    for (a, Xa, za, ra), (b, Xb, zb, rb) in [(off, on)]:
        assert torch.equal(Xa, Xb) and ra == rb
        assert np.array_equal(za, zb)
        assert torch.equal(a.last_output.ub_final, b.last_output.ub_final)
