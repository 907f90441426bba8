"""Port parity: the sparse MMW solve (sig_sdp_mmw_torch.models.mmw_ell vs
sig_sdp_mmw_tpu.models.mmw_ell) on the same K=300 state and operands,
carried across with ``from_jax_arrays``, and the same random draws (the
JAX package's, handed to the port by ``JaxDraws``).

Tolerances: float64, |Δub| < 1e-8 and the Gram X_half X_halfᵀ to 1e-6 of
its max (the averaged-Gram accumulator is float32 in both); float32,
|Δub| < 1e-4 (the tests/test_ell.py:124 standard) and the Gram to 2e-3 of
its max (the tests/test_ell.py:178 standard).  The float64 block-operand
runs use ``gram_mode="edge"``: the JAX block accumulator is float32-typed
and its loop refuses a float64 carry."""

import jax
import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.core.ell import ell_from_scipy as j_ell
from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell as j_solve
from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state as j_ops
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.models.mmw_ell import MMWEll
from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell as t_solve
from sig_sdp_mmw_torch.ops import bcsr as tb
from sig_sdp_mmw_torch.parallel.mesh import MeshAxis
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

NIT = 15
KW = dict(eta=0.05, D_pad=32, rank_pad=32, lanczos_m=8)


@pytest.fixture(scope="module")
def state():
    S, Q, h = generate_large_state_csr(10, 75e-4, seed=2)
    lb = int(np.diff(Q.indptr).max()) + 1
    return S, Q, h, float(lb + 3)


def _gram(X):
    X = np.asarray(X, np.float64)
    return X @ X.T


def _run_both(state, dtype, gram_mode="auto", backend="flat", nit=NIT,
              **kw):
    S, Q, h, Z = state
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    ej = j_ell(S, Q, h, dtype=np_dt)
    opj = None
    if backend == "flat":
        opj = j_ops(S, Q, block=128, dtype=np_dt, store_transpose=True,
                    flat_group=4)
    key = jax.random.PRNGKey(0)
    oj = j_solve(ej, Z, nit=nit, key=key, bcsr=opj, gram_mode=gram_mode,
                 **KW, **kw)
    et = tell.from_jax_arrays(jax_fields(ej))
    opt = None if opj is None else tb.from_jax_arrays(jax_fields(opj))
    ot = t_solve(et, Z, nit=nit, draws=JaxDraws(key, nit), bcsr=opt,
                 gram_mode=gram_mode, **KW, **kw)
    assert ot.X_half.dtype == dtype
    return oj, ot


@pytest.mark.parametrize("backend,gram_mode", [("flat", "edge"),
                                               ("ell", "auto")])
def test_mmw_solve_ell_float64_matches_jax(state, backend, gram_mode):
    oj, ot = _run_both(state, torch.float64, gram_mode, backend)
    assert abs(float(ot.ub_final) - float(oj.ub_final)) < 1e-8
    Gj = _gram(oj.X_half)
    assert np.abs(_gram(ot.X_half) - Gj).max() <= 1e-6 * np.abs(Gj).max()


@pytest.mark.parametrize("gram_mode", ["auto", "edge"])
def test_mmw_solve_ell_float32_matches_jax(state, gram_mode):
    oj, ot = _run_both(state, torch.float32, gram_mode)
    assert abs(float(ot.ub_final) - float(oj.ub_final)) < 1e-4
    Gj = _gram(oj.X_half)
    assert np.abs(_gram(ot.X_half) - Gj).max() <= 2e-3 * np.abs(Gj).max()


def test_mmw_solve_ell_gap_log_matches_jax(state):
    """log_gap: the (UB, LB) trajectory, LB from the gap Lanczos on the
    averaged loss, in float64; factorize=False skips the epilogue."""
    oj, ot = _run_both(state, torch.float64, "edge", nit=4, log_gap=True,
                       gap_lanczos_m=16, factorize=False)
    want = np.asarray(oj.gap_log)
    assert want.shape == (4, 2)
    np.testing.assert_allclose(ot.gap_log.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    assert float(torch.abs(ot.X_half).max()) == 0.0


def test_slim_state_matches_jax_and_full_state(state):
    """EllSlim arrays equal the JAX slim build, and a slim-state solve
    equals the full-state one."""
    from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr as j_slim

    S, Q, h, Z = state
    sj = jax_fields(j_slim(S, Q, h, dtype=np.float64))
    st = tell.ell_slim_from_csr(S, Q, h, dtype=np.float64)
    for k, v in sj.items():
        if k == "K":
            assert st.K == v
        else:
            np.testing.assert_array_equal(getattr(st, k).numpy(), v)
    ops = tb.bcsr_operands_from_state(S, Q, block=128, dtype=torch.float64,
                                      flat_group=4)
    full = tell.ell_from_scipy(S, Q, h, dtype=np.float64)
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    a = t_solve(full, Z, nit=5, draws=TorchDraws(1), bcsr=ops, **KW)
    b = t_solve(st, Z, nit=5, draws=TorchDraws(1), bcsr=ops, **KW)
    assert abs(float(a.ub_final) - float(b.ub_final)) < 1e-12
    np.testing.assert_allclose(b.X_half.numpy(), a.X_half.numpy(),
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="EllSlim"):
        t_solve(st, Z, nit=1, draws=TorchDraws(1), **KW)


def test_ell_state_matches_jax(state):
    S, Q, h, _ = state
    ej = jax_fields(j_ell(S, Q, h))
    et = tell.ell_from_scipy(S, Q, h)
    for k, v in ej.items():
        if isinstance(v, int):
            assert getattr(et, k) == v, k
        else:
            np.testing.assert_array_equal(getattr(et, k).numpy(), v)
    assert et.degree_bounds() == j_ell(S, Q, h).degree_bounds()
    # the array fallback (no host caches) gives the same bounds
    import dataclasses

    bare = dataclasses.replace(et, lb_cache=-1, ub_cache=-1)
    assert bare.degree_bounds() == et.degree_bounds()


def test_mmwell_pins_sketch_width_and_needs_prepare(state):
    """The first probe pins (D_pad, rank_pad); a smaller later Z reuses it;
    a solve, or a native rounding, without prepare() is refused.  The
    device rounding (the default) needs no host state and pins its Z_pad
    the same way."""
    S, Q, h, _ = state
    ell = tell.ell_from_scipy(S, Q, h)
    alg = MMWEll(nit=2, eta=0.05, use_bcsr=True, lanczos_m=8)
    with pytest.raises(RuntimeError, match="prepare"):
        alg.run_with_state(0, 40, ell)
    alg.prepare(ell, S, Q, h_max=h, block=128, flat_group=4)
    _, X = alg.run_with_state(0, 40, ell)
    assert X.shape == (ell.Kp, 128)
    _, X = alg.run_with_state(1, 12, ell)
    assert X.shape == (ell.Kp, 128) and alg._pinned[1:] == (128, 128)
    other = tell.ell_from_scipy(S, Q, h)
    with pytest.raises(RuntimeError, match="prepare"):
        MMWEll(nit=2, eta=0.05, rounding="native").rounding(12, X, other)
    alg.rounding(40, X, ell, nattempt=1)
    alg.rounding(12, X, ell, nattempt=1)
    assert alg._pinned_zpad[1] == 64 and alg.rounding_info[-1]["route"] == "batch"
    with pytest.raises(ValueError, match="rounding must be"):
        MMWEll(rounding="host")


class _WholeAxis(MeshAxis):
    """A graph axis that claims two ranks but holds every row in this one
    process: the solver takes its sharded path's generic Lanczos operator
    (``L_apply``, then the gather, here the rows themselves) with one
    process's arithmetic."""

    def rows(self, n):
        return 0, n

    def gather_rows(self, local, n, unit=1):
        return local

    def sum_over(self, partial):
        return partial

    def max_over(self, x):
        return x


@pytest.mark.parametrize("dt,backend", [("float32", "flat"),
                                        ("float64", "flat"),
                                        ("float32", "ell"),
                                        ("float64", "ell")])
def test_split_operator_is_the_generic_apply(monkeypatch, dt, backend):
    """On one process the solver hands the Lanczos steps its operator split
    into parts (SplitOperator, the scale 0.5 among them); through the plain
    version that gives the same y as ``0.5 * L_apply(V)`` (the generic form
    the sharded path takes, LanczosOperator), bit for bit, and the same
    X_half and ub_final for a whole solve at cell 8 (bfloat16 blocks with a
    float32 state, float64 blocks with a float64 one; or the ELL state)."""
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr as gen
    from sig_sdp_mmw_torch.models import mmw_ell as tm
    from sig_sdp_mmw_torch.ops import expm as te
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    dtype = getattr(torch, dt)
    S, Q, h = gen(8, 75e-4, seed=2)
    e = tell.ell_from_scipy(S, Q, h, dtype=np.float32 if dt == "float32"
                            else np.float64)
    ops = None
    if backend == "flat":
        ops = tb.bcsr_operands_from_state(
            S, Q, block=128, store_transpose=True, flat_group=4,
            dtype=torch.bfloat16 if dt == "float32" else dtype)
    seen = []
    real = tm.lanczos_expm_multiply

    def recording(op, V, *a, **kw):
        seen.append((op, V))
        return real(op, V, *a, **kw)

    monkeypatch.setattr(tm, "lanczos_expm_multiply", recording)
    kw = dict(nit=6, eta=0.05, D_pad=32, rank_pad=32, lanczos_m=8, bcsr=ops)
    split = t_solve(e, 9.0, draws=TorchDraws(3, "cpu", stream=1), **kw)
    generic = t_solve(e, 9.0, draws=TorchDraws(3, "cpu", stream=1),
                      graph=_WholeAxis(size=2), **kw)
    (op_s, G), (op_g, G2) = seen[0], seen[6]
    assert isinstance(op_s, te.SplitOperator) and op_s.scale == 0.5
    assert isinstance(op_g, te.LanczosOperator) and op_g.scale == 0.5
    assert torch.equal(G, G2) and G.dtype == dtype
    V = torch.randn(G.shape, dtype=dtype,
                    generator=torch.Generator().manual_seed(0))
    for X in (G, V):
        assert torch.equal(op_s(X), op_g(X))
    assert torch.equal(split.X_half, generic.X_half)
    assert torch.equal(split.ub_final, generic.ub_final)


# ---- the slim state on the normal path (the million-link deployment) ------

SLIM_KW = dict(nit=12, eta=0.05, use_bcsr=True, rounding="native",
               nattempt=3, seed=2**31 + 5)


def _port_state(cell, seed):
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr as gen

    return gen(cell, 75e-4, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slim_degree_bounds_equal_the_full_state(seed):
    """The slim state's cached bounds (host CSR, at build) are the full
    state's, and the slim view of a full state keeps them."""
    S, Q, h = _port_state(8, seed)
    full = tell.ell_from_scipy(S, Q, h)
    slim = tell.ell_slim_from_csr(S, Q, h)
    assert slim.degree_bounds() == full.degree_bounds()
    assert slim.asso_lower_bound() == full.asso_lower_bound()
    view = tell.ell_slim(full)
    assert view.degree_bounds() == full.degree_bounds()
    import dataclasses

    with pytest.raises(ValueError, match="degree bounds"):
        dataclasses.replace(slim, lb_cache=-1).degree_bounds()


class _Probes:
    """The search's feasibility check: ``MMWEll``, each probe's Z, rem,
    bound and sketches recorded."""

    def __init__(self, alg):
        self.alg, self.seen = alg, []

    def run_with_state(self, it, Z, state):
        ok, gX = self.alg.run_with_state(it, Z, state)
        out = self.alg.last_output
        self.solved = dict(Z=int(Z), ub=float(out.ub_final),
                           parts=out.ub_parts.tolist(),
                           stream=self.alg._ncall, D_pad=self.alg._pinned[1])
        return ok, gX

    def rounding(self, Z, gX, state):
        z, Zr, rem = self.alg.rounding(Z, gX, state)
        self.seen.append(dict(self.solved, rem=int(rem)))
        return z, Zr, rem


def _search(state, S, Q, h):
    from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation

    alg = MMWEll(**SLIM_KW)
    alg.prepare(state, S, Q, h_max=h, block=128, dtype=torch.bfloat16,
                store_transpose=True, weights_dtype=torch.bfloat16)
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = probes = _Probes(alg)
    _, Z, rem = bs.run(state)
    return Z, rem, probes.seen, alg


def test_slim_search_matches_the_full_state():
    """The binary search on the slim state, through ``MMWEll`` with the
    host rounding, probes what the full state probes and returns its Z;
    each probe's bound and its three parts agree to 1e-6 relative (the
    slim state's S̃ row sums are float64 sums cast to float32, the full
    state's float32 sums over its ELL rows: other roundings of the same
    numbers), and the bound is the largest part.  The probe at the
    smallest Z is the reference's float64 solve with the same sketches and
    bfloat16 products, its bound and each part to the sig1m cell's ub_gap
    limit."""
    import json
    import os

    from portbench.reference import mmw as ref
    from portbench.reference.ub_parts import ub_parts
    from sig_sdp_mmw_torch.models.mmw_ell import gram_route

    S, Q, h = _port_state(10, 3)
    Kp = 384                                   # K=300 in 128-row blocks
    slim = tell.ell_slim_from_csr(S, Q, h, pad_rows_to=Kp)
    full = tell.ell_from_scipy(S, Q, h, pad_rows_to=Kp)
    Zs, rs, ps, alg = _search(slim, S, Q, h)
    Zf, rf, pf, _ = _search(full, S, Q, h)
    assert (Zs, rs) == (Zf, rf) and rs == 0 and len(ps) >= 3
    assert [(p["Z"], p["rem"]) for p in ps] == [(p["Z"], p["rem"])
                                                for p in pf]
    for a, b in zip(ps, pf):
        assert abs(a["ub"] - b["ub"]) <= 1e-6 * abs(b["ub"])
        assert a["ub"] == max(a["parts"])
        np.testing.assert_allclose(a["parts"], b["parts"], rtol=1e-6)
    assert alg.last_solve["gram_mode"] == gram_route(alg.bcsr)[0]
    assert alg.last_solve["maxblk"] == alg.bcsr.s_blocks.bcols.shape[1]
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "portbench", "workloads",
            "sig1m.probe.json")) as f:
        limit = json.load(f)["checks"]["ub_gap"]
    a = min(ps, key=lambda p: p["Z"])
    kw = dict(nit=SLIM_KW["nit"], eta=SLIM_KW["eta"], rank_radio=2, Kp=Kp,
              D_pad=a["D_pad"], seed=SLIM_KW["seed"], stream=a["stream"],
              device="cpu", low="bfloat16")
    St, edges = ref.s_tilde(S, Q), ref.assoc_edges(Q)
    want = ref.ub_final(St, edges, h, a["Z"], **kw)
    parts = ub_parts(St, edges, h, a["Z"], **kw)
    assert max(parts) == want
    assert abs(a["ub"] - want) <= limit
    assert max(abs(g - w) for g, w in zip(a["parts"], parts)) <= limit


def test_slim_state_refuses_the_device_rounding():
    """A slim state holds no ELL arrays: the device rounding (the default)
    and a solver without block operands are refused, naming the way."""
    S, Q, h = _port_state(8, 1)
    slim = tell.ell_slim_from_csr(S, Q, h, pad_rows_to=256)
    with pytest.raises(ValueError, match='rounding="native"'):
        MMWEll(use_bcsr=True).prepare(slim, S, Q, h_max=h, block=128)
    with pytest.raises(ValueError, match="use_bcsr"):
        MMWEll(rounding="native").prepare(slim, S, Q, h_max=h)
    X = torch.zeros((slim.Kp, 32))
    with pytest.raises(ValueError, match='rounding="native"'):
        MMWEll(use_bcsr=True).rounding(9, X, slim)


@pytest.mark.parametrize("gram_mode", ["edge", "block"])
def test_gram_span_names_its_route(monkeypatch, gram_mode):
    """``mmw_ell.gram`` carries its route (``mode``) and is timed on the
    edge route only, so the block route records no timing events."""
    from sig_sdp_mmw_torch.models import mmw_ell as tm
    from sig_sdp_mmw_torch.utils import profiling
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    S, Q, h = _port_state(8, 2)
    slim = tell.ell_slim_from_csr(S, Q, h, pad_rows_to=256)
    ops = tb.bcsr_operands_from_state(S, Q, block=128, store_transpose=True,
                                      dtype=torch.bfloat16)
    opened = []
    real = tm.span

    def spy(name, timed=False, **attrs):
        if name == "mmw_ell.gram":
            opened.append((timed, attrs["mode"]))
        return real(name, timed, **attrs)

    monkeypatch.setattr(tm, "span", spy)
    with profiling.tracing():
        t_solve(slim, 9.0, nit=3, eta=0.05, D_pad=32, rank_pad=32,
                draws=TorchDraws(1), bcsr=ops, gram_mode=gram_mode)
    grams = [s for s in profiling.spans() if s.name == "mmw_ell.gram"]
    assert [s.attrs["mode"] for s in grams] == [gram_mode] * 3
    assert opened == [(gram_mode == "edge", gram_mode)] * 3
    assert tm.gram_route(ops, "auto") == ("block",
                                          ops.s_blocks.bcols.shape[1])
    assert tm.gram_route(None) == ("ell", 0)
    with pytest.raises(ValueError, match="gram_mode"):
        tm.gram_route(ops, "dense")


def test_slim_gram_routes_agree():
    """On a slim state the edge Gram and the block Gram accumulate the same
    averaged primal: the same bound and parts (read before the Gram), and
    the factor to float32's rounding of two summation orders."""
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    S, Q, h = _port_state(8, 4)
    slim = tell.ell_slim_from_csr(S, Q, h, pad_rows_to=256)
    ops = tb.bcsr_operands_from_state(S, Q, block=128, store_transpose=True,
                                      dtype=torch.bfloat16,
                                      weights_dtype=torch.bfloat16)
    out = {g: t_solve(slim, 9.0, nit=4, eta=0.05, D_pad=32, rank_pad=32,
                      draws=TorchDraws(7), bcsr=ops, gram_mode=g)
           for g in ("edge", "block")}
    e, b = out["edge"], out["block"]
    assert torch.equal(e.ub_parts, b.ub_parts)
    assert torch.equal(e.ub_final, torch.max(e.ub_parts))
    G = lambda o: o.X_half @ o.X_half.T              # noqa: E731
    torch.testing.assert_close(G(e), G(b), rtol=1e-4, atol=1e-5)
