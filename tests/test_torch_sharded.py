"""Port parity: the graph-sharded solves (sig_sdp_mmw_torch.models.mmw and
.mmw_ell with ``graph``, parallel.batch.solve_scenarios_batched with a
mesh) over 4 gloo ranks on the CPU, against the unsharded port and the JAX
package on the K=75 reference fixture, with the JAX package's draws.

One launch of 4 ranks runs every case (tests/torch_sharded_worker.py,
which imports no jax): graph 4 on a batch 1 x graph 4 mesh, graph 2 on a
batch 2 x graph 2 mesh (both mesh rows solve the same instance), and the
batched solve of 4 instances on the batch 2 x graph 2 mesh.

Tolerances (tests/test_parallel.py's): float64, every rank bit for bit
equal; against the unsharded port |Δub| <= 1e-10 and max|ΔX_half| <=
1e-10; against JAX |Δub| <= 1e-4 and, for the block solve, the X_half
Gram to 2e-4 (X_half's column signs are each eigensolver's choice).  The
float32 block case replays the JAX test's own sharded run (batch 4 x
graph 2 in JAX, graph 2 here): |Δub| <= 1e-4, max|ΔX_half| <= 2e-4 after
aligning column signs, and the unsharded port to the same 1e-4 and 2e-4
(float32: the epilogue's transpose sums each rank's rows first)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sig_sdp_mmw_tpu.core import ell as jell
from sig_sdp_mmw_tpu.core.problem import state_from_arrays as j_state
from sig_sdp_mmw_tpu.core.problem import state_to_scipy as j_to_scipy
from sig_sdp_mmw_tpu.models.mmw import mmw_solve as j_mmw
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell as j_mmw_ell
from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state as j_ops
from sig_sdp_mmw_tpu.parallel import make_mesh as j_make_mesh
from sig_sdp_mmw_torch.core import ell as tell
from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.models.mmw import mmw_solve as t_mmw
from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell as t_mmw_ell
from sig_sdp_mmw_torch.ops import bcsr as tb
from sig_sdp_mmw_torch.parallel import solve_scenarios_batched, stack_states
from sig_sdp_mmw_torch.parallel.distributed import launch
from torch_jax_parity import JaxDraws, jax_fields
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_sharded_worker import RecordingDraws

KW = dict(nit=8, eta=0.05, D_pad=32, rank_pad=32)
Z = 8.0
GRAPHS = {2: 2, 4: 1}     # graph axis length -> the mesh's batch length
B = 4


def _sign_aligned(X, ref):
    X, ref = np.asarray(X, np.float64), np.asarray(ref, np.float64)
    s = np.sign(np.sum(X * ref, axis=0))
    return X * np.where(s == 0, 1.0, s)[None, :]


def _gram(X):
    X = np.asarray(X, np.float64)
    return X @ X.T


@pytest.fixture(scope="module")
def parity(mmw_small):
    fix = mmw_small
    js = j_state(fix["S"], fix["Q"], fix["h_max"], dtype=jnp.float64)
    ts = from_jax_arrays(jax_fields(js))
    S = scipy.sparse.csr_matrix(np.asarray(fix["S"], np.float64))
    Q = scipy.sparse.csr_matrix(np.asarray(fix["Q"], np.float64))
    j_ell64 = jell.ell_from_scipy(*j_to_scipy(js), dtype=np.float64)
    t_ell64 = tell.ell_from_sig_state(ts, dtype=np.float64)
    cases, want, jax_out = {}, {}, {}

    def add(name, kind, key, run_port, run_jax, **args):
        rec = RecordingDraws(JaxDraws(key, KW["nit"]))
        want[name] = run_port(rec)
        jax_out[name] = run_jax()
        for g, b in GRAPHS.items():
            cases[f"{name}_g{g}"] = (kind, dict(batch_size=b,
                                                draws=rec.record(), Z=Z,
                                                **KW, **args))

    # Dense (tests/test_parallel.py:54-74).
    k = jax.random.PRNGKey(5)
    add("dense", "dense", k,
        lambda d: t_mmw(ts, Z, draws=d, **KW),
        lambda: j_mmw(js, Z, key=k, **KW), state=ts)
    # ELL (:77-107), the state's rows split over the ranks.
    k = jax.random.PRNGKey(7)
    add("ell", "ell", k,
        lambda d: t_mmw_ell(t_ell64, Z, draws=d, **KW),
        lambda: j_mmw_ell(j_ell64, Z, key=k, **KW), ell=t_ell64)
    # Block-sparse (8, 8) blocks in float64: the slim state with S̃ᵀ by
    # scatter (the packer's default), and with S̃ᵀ stored and flat twins.
    k = jax.random.PRNGKey(11)
    slim = tell.ell_slim(t_ell64)
    for name, kw in (("bcsr", {}),
                     ("bcsr_flat", dict(store_transpose=True, flat_group=4))):
        opj = j_ops(S, Q, block=(8, 8), dtype=np.float64, **kw)
        opt = tb.from_jax_arrays(jax_fields(opj))
        add(name, "bcsr", k,
            lambda d, o=opt: t_mmw_ell(slim, Z, draws=d, bcsr=o,
                                       gram_mode="edge", **KW),
            lambda o=opj: j_mmw_ell(j_ell64, Z, key=k, bcsr=o,
                                    gram_mode="edge", **KW),
            ell=slim, bcsr=opt, gram_mode="edge")
    # Float32 blocks, as the JAX test: its operands sharded over a
    # batch 4 x graph 2 mesh, the port's over graph 2.
    js32 = j_state(fix["S"], fix["Q"], fix["h_max"], dtype=jnp.float32)
    j_ell32 = jell.ell_from_sig_state(js32)
    t_ell32 = tell.ell_from_sig_state(from_jax_arrays(jax_fields(js32)))
    opj = j_ops(S, Q, block=(8, 8))
    opt = tb.from_jax_arrays(jax_fields(opj))
    mesh = j_make_mesh(8, batch_size=4)
    Kbr = opj.s_blocks.Kb

    def shard(x):
        if getattr(x, "ndim", 0) >= 2 and x.shape[0] == Kbr:
            return jax.device_put(
                x, NamedSharding(mesh, P("graph", *([None] * (x.ndim - 1)))))
        return jax.device_put(x, NamedSharding(mesh, P()))

    k = jax.random.PRNGKey(11)
    rec = RecordingDraws(JaxDraws(k, KW["nit"]))
    want["bcsr32"] = t_mmw_ell(t_ell32, Z, draws=rec, bcsr=opt, **KW)
    jax_out["bcsr32"] = jax.jit(lambda e, key, b: j_mmw_ell(
        e, Z, key=key, bcsr=b, **KW))(j_ell32, k, jax.tree.map(shard, opj))
    cases["bcsr32_g2"] = ("bcsr", dict(batch_size=2, draws=rec.record(), Z=Z,
                                       ell=t_ell32, bcsr=opt, **KW))
    # The batched solve (:36-51): 4 instances over the 2 mesh rows.
    k = jax.random.PRNGKey(0)
    bkw = dict(nit=10, eta=0.05, D_pad=32, rank_pad=32)
    states = stack_states([ts] * B)
    rec = RecordingDraws(JaxDraws(k, bkw["nit"]))
    want["batched"] = solve_scenarios_batched(states, Z, draws=rec, **bkw)
    keys = jax.random.split(k, B)
    jax_out["batched"] = [j_mmw(js, Z, key=keys[b], **bkw)
                          for b in range(B)]
    cases["batched"] = ("batched", dict(batch_size=2, draws=rec.record(),
                                        Z=Z, states=states, **bkw))

    ranks = launch("torch_sharded_worker:sharded_solves", 4, (cases,),
                   backend="gloo", timeout_s=300)
    return dict(ranks=ranks, want=want, jax=jax_out, cases=list(cases))


def _case(parity, name):
    return parity["ranks"][0][name]


def test_every_rank_returns_the_same_bits(parity):
    for name in parity["cases"]:
        r0 = _case(parity, name)
        for rec in parity["ranks"][1:]:
            np.testing.assert_array_equal(rec[name]["X_half"], r0["X_half"])
            np.testing.assert_array_equal(rec[name]["ub_final"],
                                          r0["ub_final"])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["dense", "ell", "bcsr", "bcsr_flat"])
def test_sharded_solve_matches_unsharded_port_and_jax(parity, name, graph):
    got = _case(parity, f"{name}_g{graph}")
    assert got["shape"] == {"batch": GRAPHS[graph], "graph": graph}
    assert got["gathered_bytes"] > 0
    want, oj = parity["want"][name], parity["jax"][name]
    assert abs(float(got["ub_final"]) - float(want.ub_final)) <= 1e-10
    np.testing.assert_allclose(got["X_half"], want.X_half.numpy(), rtol=0,
                               atol=1e-10)
    assert abs(float(got["ub_final"]) - float(oj.ub_final)) <= 1e-4
    if name.startswith("bcsr"):
        np.testing.assert_allclose(_gram(got["X_half"]), _gram(oj.X_half),
                                   rtol=0, atol=2e-4)


def test_float32_block_solve_matches_jax_sharded_run(parity):
    got = _case(parity, "bcsr32_g2")
    oj, want = parity["jax"]["bcsr32"], parity["want"]["bcsr32"]
    assert abs(float(got["ub_final"]) - float(oj.ub_final)) <= 1e-4
    np.testing.assert_allclose(_sign_aligned(got["X_half"], oj.X_half),
                               np.asarray(oj.X_half, np.float64), rtol=0,
                               atol=2e-4)
    assert abs(float(got["ub_final"]) - float(want.ub_final)) <= 1e-4
    np.testing.assert_allclose(got["X_half"], want.X_half.numpy(), rtol=0,
                               atol=2e-4)


def test_batched_mesh_solve_matches_jax_single_solves(parity):
    got = _case(parity, "batched")
    assert got["shape"] == {"batch": 2, "graph": 2}
    assert got["X_half"].shape == (B, 80, 32)
    want = parity["want"]["batched"]
    np.testing.assert_allclose(got["ub_final"], want.ub_final.numpy(),
                               rtol=0, atol=1e-10)
    for b, oj in enumerate(parity["jax"]["batched"]):
        assert abs(float(got["ub_final"][b]) - float(oj.ub_final)) <= 1e-4
        np.testing.assert_allclose(_gram(got["X_half"][b]), _gram(oj.X_half),
                                   rtol=0, atol=1e-4)


def test_ell_from_sig_state_and_slim_match_jax(mmw_small):
    fix = mmw_small
    js = j_state(fix["S"], fix["Q"], fix["h_max"], dtype=jnp.float32)
    ej = jell.ell_from_sig_state(js)
    et = tell.ell_from_sig_state(from_jax_arrays(jax_fields(js)))
    for f in dataclasses.fields(et):
        a, b = getattr(et, f.name), getattr(ej, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    sj, st = jell.ell_slim(ej), tell.ell_slim(et)
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(sj, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0, err_msg=f.name)
        else:
            assert a == b


@pytest.fixture(scope="module")
def operands(mmw_small):
    S = scipy.sparse.csr_matrix(np.asarray(mmw_small["S"], np.float64))
    Q = scipy.sparse.csr_matrix(np.asarray(mmw_small["Q"], np.float64))
    return tb.bcsr_operands_from_state(S, Q, block=(8, 8),
                                       dtype=torch.float64,
                                       store_transpose=True, flat_group=4)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("field", ["s_blocks", "st_blocks", "s_flat"])
def test_row_shards_products_stack_to_the_whole(operands, field, n):
    """The plain products of the n row shards, stacked, are the whole
    operand's product; each shard keeps the column count and takes V of
    the whole operand's rows (the kernels' operand checks agree)."""
    full = getattr(operands, field)
    V = torch.randn((full.nrows, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n))
    flat = field == "s_flat"
    fn = tb.bsr_spmm_flat_reference if flat else tb.bcsr_spmm_reference
    parts = [tb.shard_rows(full, g, n) for g in range(n)]
    unsupported = (tb.flat_kernel_unsupported if flat
                   else tb.ell_kernel_unsupported)
    for p in parts:
        assert p.ncols == full.nrows and p.nrows < full.nrows
        p32 = dataclasses.replace(p, blocks=p.blocks.float())
        assert unsupported(p32, V.float()) is None
        assert f"V must be [{full.nrows}, D]" in unsupported(
            p32, V[:p.nrows].float())
    np.testing.assert_array_equal(torch.cat([fn(p, V) for p in parts]),
                                  fn(full, V))


@pytest.mark.parametrize("n", [2, 3])
def test_row_shards_split_every_map(operands, n):
    """Each S̃ edge, Gram map entry and association entry lands in exactly
    one shard, renumbered to it."""
    parts = [tb.shard_rows(operands, g, n) for g in range(n)]
    np.testing.assert_array_equal(torch.cat([p.w_edge for p in parts]),
                                  operands.w_edge)
    assert sum(p.nnz for p in parts) == operands.nnz
    assert sum(p.q_pos.numel() for p in parts) == operands.q_pos.numel()
    assert sorted(torch.cat([p.q_eidx for p in parts]).tolist()) == sorted(
        operands.q_eidx.tolist())
    for p in parts:
        real = p.g_dst < p.nnz
        assert int(real.sum()) == p.nnz
        assert sorted(p.g_dst[real].tolist()) == list(range(p.nnz))
        nslots = p.s_blocks.blocks.numel()
        assert int(p.s_pos.max()) < nslots and int(p.s_pos.min()) >= 0
        assert int(p.q_pos.max()) < p.q_bcols.numel() * 64


def test_sharded_transpose_sums_to_the_whole(operands):
    """A^T V from row shards: each shard's rows scattered into every column
    block (ncols), summed, equal the whole operand's."""
    sb = operands.s_blocks
    V = torch.randn((sb.nrows, 6), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    whole = tb.bcsr_spmm_transpose(sb.bcols, sb.blocks, V)
    total = torch.zeros_like(whole)
    for g in range(3):
        p = tb.shard_rows(sb, g, 3)
        r0 = g * -(-sb.Kb // 3) * sb.Brow
        total += tb.bcsr_spmm_transpose(p.bcols, p.blocks,
                                        V[r0:r0 + p.nrows], ncols=sb.nrows)
    np.testing.assert_allclose(total, whole, rtol=0, atol=1e-12)
