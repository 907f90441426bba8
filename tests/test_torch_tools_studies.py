"""Port parity of the six tools studies
(``sig_sdp_mmw_torch/experiments/{plateau_study,million_link,
million_z19_probe,reorder_bench,perf_sweep,profile_bcsr_build}.py``) against
the JAX tools' own inner functions (``run_cell``, ``run_one``,
``million_link.main(out_path=)``, the z19 probe's and perf_sweep's loop
bodies; never a ``main`` that writes into the repo root), on the CPU,
through the kernels' plain versions, with the JAX package's draws:

* plateau at cell 12 (K=432; nit 10 in segments of 5 at Z_fin): the
  search's Z path, each probe's remainder and Z_fin, as the tool prints
  them, and the segments' ub to 1e-4 beside the tool's rounding to 4
  decimals (``tests/test_ell.py:111-125``'s standard for shared draws);
* million_link at cell 12, 64x64 blocks, nit 6 in segments of 3, with the
  device rounding: K, nnz, Kb, maxblk, fill, lb, Z, D_pad, the ub curve to
  1e-4, the remainder and the checker's verdict;
* the z19 probe's body at cell 12, Z = lb + 4, nit 6: ub to 1e-4, the same
  remainder (``lanczos_m`` 8 in both, the port's value);
* reorder_bench's raster 128x128 and Hilbert 8x128 runs at cell 12, nit 5:
  the same fill, maxblk, Z and D_pad, ub of the last timed solve to 1e-4;
* perf_sweep on the fixture's users at m = 16 and 8 (the solver's floor):
  ub to 1e-4 against JAX's ``mmw_solve``; the fixture equals JAX's draw
  bit for bit;
* profile_bcsr_build at cell 12: every size equals the JAX package's
  build (``_bcsr_arrays_np``, its operands' Gram maps, weights and
  association layout) on the same CSR;
* ``bler_tail_fix --draw-seeds`` at cell 12, nit 20: seed 3 gives the
  default's probes, each seed's case carries its seed, and the re-rounding
  report runs only where no seed finds a Z;
* no entry point writes outside ``--out``.

The state is float32 in both packages (``jax.enable_x64(False)`` around
the JAX side, as the tools run).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.experiments import (bler_tail_fix, million_link,
                                           million_z19_probe, perf_sweep,
                                           plateau_study, profile_bcsr_build,
                                           reorder_bench)
from torch_jax_geometry import PERF_SWEEP_FIXTURE, jax_geometry
from torch_jax_parity import REPO, JaxDraws, script
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

CELL = 12


def tool(name):
    return script("tools", name)


def test_plateau_study_matches_the_tool(capsys):
    nit, seg = 10, 5
    with jax.enable_x64(False):
        want = tool("plateau_study").run_cell(jax, CELL, nit=nit, seg=seg)
    printed = capsys.readouterr().out
    want_probes = [(int(z), int(r)) for z, r in re.findall(
        rf"cell={CELL} probe Z=(\d+) rem=(\d+)", printed)]
    key = jax.random.PRNGKey(11)

    def draws(role, Z):
        if role == "solve":
            return JaxDraws(jax.random.fold_in(key, Z), nit=60)
        if role == "round":
            return JaxDraws(jax.random.fold_in(key, 77 + Z), nattempt=6)
        return JaxDraws(key, nit=nit)

    got = plateau_study.run_cell(CELL, nit=nit, seg=seg, device="cpu",
                                 draws=draws)
    assert [(p["Z"], p["rem"]) for p in got["probes"]] == want_probes
    for k in ("K", "C", "lb", "Z_fin", "eta", "nit"):
        assert got[k] == want[k], k
    assert abs(got["lnC"] - want["lnC"]) <= 0.005
    assert [i for i, _ in got["curve"]] == [i for i, _ in want["curve"]]
    np.testing.assert_allclose([u for _, u in got["curve"]],
                               [u for _, u in want["curve"]], rtol=0,
                               atol=5e-5 + 1e-4)


def test_million_link_matches_the_tool(tmp_path):
    kw = dict(cell=CELL, nit=6, block=64, segment=3, do_rounding=True)
    with jax.enable_x64(False):
        want = tool("million_link").main(out_path=str(tmp_path / "jax.json"),
                                         **kw)

    def draws(role):
        if role == "round":
            return JaxDraws(jax.random.PRNGKey(7), nattempt=1)
        return JaxDraws(jax.random.PRNGKey(0), nit=kw["nit"])

    got = million_link.main(out_path=str(tmp_path / "port.json"),
                            device="cpu", draws=draws, **kw)
    for k in ("K", "nnz_S", "nnz_Q", "bcsr_Kb", "bcsr_maxblk", "lb",
              "Z_probe", "D_pad", "segment", "rounding_rem", "verified"):
        assert got[k] == want[k], k
    assert abs(got["block_fill_pct"] - want["block_fill_pct"]) <= 5e-4
    assert [i for i, _ in got["ub_curve"]] == [i for i, _ in want["ub_curve"]]
    np.testing.assert_allclose([u for _, u in got["ub_curve"]],
                               [u for _, u in want["ub_curve"]], rtol=0,
                               atol=5e-5 + 1e-4)
    np.testing.assert_allclose(got["ub_final"], want["ub_final"], rtol=0,
                               atol=1e-4)
    assert (got["rounding_rem"] == 0) == got["verified"]["ok"]


def test_million_z19_probe_matches_the_tool():
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_tpu.core.ell import build_st_csr, ell_slim_from_csr
    from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_tpu.models.rounding_ell import (rounding_native_csr,
                                                     verify_assignment_csr)
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = LargeEnv(CELL, 75e-4, seed=0).generate_state_csr()
    Z = int(np.diff(Q.indptr).max()) + 1 + 4
    nit, segment, m, nattempt = 6, 3, 8, 10
    # The tool's body (tools/million_z19_probe.py:38-72), float32 in JAX.
    with jax.enable_x64(False):
        slim = ell_slim_from_csr(S, Q, h)
        ops = bcsr_operands_from_state(
            S, Q, block=128, dtype=jnp.bfloat16, store_transpose=False,
            weights_dtype=jnp.bfloat16)
        StT = build_st_csr(S, Q).transpose().tocsr()
        kw = dict(nit=nit, eta=0.05, D_pad=48, rank_pad=48, lanczos_m=m,
                  spmm_row_chunk=2048, gram_mode="edge", rsvd_iters=2)
        seg_fn = jax.jit(lambda e, k, b, c, i0: mmw_solve_ell(
            e, float(Z), key=k, bcsr=b, carry_in=c, it_start=i0,
            num_steps=segment, return_carry=True, **kw))
        fin_fn = jax.jit(lambda e, k, b, c: mmw_solve_ell(
            e, float(Z), key=k, bcsr=b, carry_in=c, it_start=nit,
            num_steps=0, **kw))
        key = jax.random.PRNGKey(5)
        c = None
        for i0 in range(0, nit, segment):
            c = seg_fn(slim, key, ops, c, i0)
        out = fin_fn(slim, key, ops, c)
        z, _, rem = rounding_native_csr(Z, np.asarray(out.X_half), S, Q, h,
                                        jax.random.PRNGKey(77),
                                        nattempt=nattempt, StT_csr=StT)
        ok = verify_assignment_csr(S, Q, h, z)[0]

    def draws(role):
        if role == "round":
            return JaxDraws(jax.random.PRNGKey(77), nattempt=nattempt)
        return JaxDraws(jax.random.PRNGKey(5), nit=nit)

    got = million_z19_probe.probe(S, Q, h, Z, nit=nit, segment=segment,
                                  lanczos_m=m, nattempt=nattempt,
                                  device="cpu", draws=draws)
    np.testing.assert_allclose(got["ub"], float(out.ub_final), rtol=0,
                               atol=1e-4)
    assert got["rem"] == int(rem)
    assert got["verified"]["ok"] == bool(ok) == (got["rem"] == 0)


@pytest.mark.parametrize("order,block", [("raster", 128),
                                         ("hilbert", (8, 128))])
def test_reorder_bench_matches_the_tool(order, block):
    with jax.enable_x64(False):
        want = tool("reorder_bench").run_one(jax, order, cell=CELL, nit=5,
                                             block=block)
    key = jax.random.PRNGKey(0)

    def draws(i):
        return JaxDraws(key if i is None else jax.random.fold_in(key, i),
                        nit=5)

    got = reorder_bench.run_one(order, cell=CELL, nit=5, block=block,
                                device="cpu", draws=draws)
    for k in ("order", "block", "K", "nnz", "Z", "D_pad", "maxblk"):
        assert got[k] == want[k], k
    assert abs(got["block_fill_pct"] - want["block_fill_pct"]) <= 5e-3
    np.testing.assert_allclose(got["ub_final"], want["ub_final"], rtol=0,
                               atol=5e-5 + 1e-4)


def test_perf_sweep_fixture_is_the_jax_draw():
    g = np.load(PERF_SWEEP_FIXTURE)
    locs, dirs = jax_geometry(perf_sweep.ENV_SEED, perf_sweep.CELL,
                              perf_sweep.RHO)
    assert g["seeds"].tolist() == [perf_sweep.ENV_SEED]
    assert np.array_equal(g["sta_locs"][0], locs)
    assert np.array_equal(g["sta_dirs"][0], dirs)


def test_perf_sweep_matches_the_tool():
    from sig_sdp_mmw_torch.env import WirelessEnv as TEnv
    from sig_sdp_mmw_tpu.env import WirelessEnv
    from sig_sdp_mmw_tpu.models import mmw_solve

    ms, nit = (16, 8), 150
    # The tool's loop (tools/perf_sweep.py:33-46), float32 in JAX.
    with jax.enable_x64(False):
        st = WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=7,
                         pad_to=320).generate_S_Q_hmax()
        want = [float(jax.jit(lambda st, k, m=m: mmw_solve(
            st, 12.0, nit=nit, eta=0.05, D_pad=32, rank_pad=32, key=k,
            lanczos_m=m))(st, jax.random.PRNGKey(0)).ub_final) for m in ms]
    env = TEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=7, pad_to=320,
               device="cpu", **perf_sweep.geometry_users(PERF_SWEEP_FIXTURE))
    rows = perf_sweep.sweep(env.generate_S_Q_hmax(), ms, nit, n=0,
                            draws=JaxDraws(jax.random.PRNGKey(0), nit=nit))
    assert [r["m"] for r in rows] == list(ms)
    np.testing.assert_allclose([r["ub_final"] for r in rows], want, rtol=0,
                               atol=1e-4)


def test_profile_bcsr_build_sizes_match_the_jax_build():
    import math

    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_tpu.core.ell import build_st_csr
    from sig_sdp_mmw_tpu.ops.bcsr import (_bcsr_arrays_np,
                                          bcsr_operands_from_state)

    got = profile_bcsr_build.main(cell=CELL, device="cpu")
    S, Q, _ = LargeEnv(CELL, 75e-4, seed=0).generate_state_csr()
    Br, Bc = 8, 128
    St = build_st_csr(S, Q)
    St.sort_indices()
    lcm = Br * Bc // math.gcd(Br, Bc)
    nr = -(-St.shape[0] // lcm) * lcm
    bcols, blocks, _, _ = _bcsr_arrays_np(St, (Br, Bc), pad_rows_to=nr,
                                          dtype=np.float32,
                                          return_entry_maps=True)
    with jax.enable_x64(False):
        ops = bcsr_operands_from_state(S, Q, block=(Br, Bc))
    maxblkQ = ops.q_bcols.shape[1]
    pos = np.asarray(ops.q_pos).astype(np.int64) // Bc
    assert got["K"] == S.shape[0] and got["nnz"] == St.nnz
    assert got["maxblk"] == bcols.shape[1]
    assert got["blocks_gib"] == blocks.nbytes / 2**30
    assert got["gram_map_shape"] == list(ops.g_src.shape)
    assert got["weights_nnz"] == ops.w_edge.size
    assert got["q_blocks"] == np.unique(pos // (maxblkQ * Br) * maxblkQ
                                        + pos % maxblkQ).size
    assert set(got["stages_s"]) == {
        "generate", "build_st_csr", "sort_indices", "_bcsr_arrays_np(S~)",
        "gram maps", "weights P.multiply(P^T)", "q edge layout",
        "bf16 cast (host)"}


def test_bler_tail_fix_draw_seeds(monkeypatch):
    """Seed 3 is the default's draws: the same probes, bit for bit; every
    case carries its seed; where no seed finds a Z, each seed's probe at the
    window's top is rounded again as a report."""
    base = bler_tail_fix.run_case(CELL, 8, nit=20, device="cpu")
    rec = bler_tail_fix.main(cell=CELL, tail_zs=(8,), device="cpu",
                             draw_seeds=(3, 0), reround_attempts=10, nit=20)
    assert [c["draw_seed"] for c in rec["cases"]] == [3, 0]

    def probes(case):
        return [(p["Z"], p["ub"], p["rem"]) for p in case["probes"]]

    assert probes(rec["cases"][0]) == probes(base)
    assert probes(rec["cases"][1]) != probes(base)
    # Some seed found a Z: no report.
    assert base["Z_fin"] is not None
    assert not any("reround" in c for c in rec["cases"])

    rr = bler_tail_fix.reround_top(6, 8, 10, nit=20, device="cpu")
    lb = 8                                   # cell 6 with margin 8
    assert rr["Z"] == lb + 8 and rr["nattempt"] == 10
    assert rr["rem"] > 0 or rr["verified"]["ok"]
    calls = []
    monkeypatch.setattr(bler_tail_fix, "run_case",
                        lambda *a, **k: dict(Z_fin=None, probes=[]))
    monkeypatch.setattr(bler_tail_fix, "reround_top",
                        lambda *a, **k: calls.append(k["draws"]) or {"Z": 0})
    rec = bler_tail_fix.main(cell=6, tail_zs=(8,), device="cpu",
                             draw_seeds=(0, 1), reround_attempts=10)
    assert [c["reround"] for c in rec["cases"]] == [{"Z": 0}] * 2
    assert len(calls) == 2


def test_tools_studies_write_only_their_outputs(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = set(os.listdir(REPO))
    out = tmp_path / "out"
    out.mkdir()
    plateau_study.main(cells=(6,), device="cpu", out=str(out / "plateau.json"),
                       nit=4, seg=2)
    million_link.main(cell=6, nit=3, block=64, device="cpu",
                      out_path=str(out / "ml.json"))
    million_z19_probe.main(cell=6, nit=3, device="cpu",
                           out=str(out / "z19.json"))
    reorder_bench.main(cell=6, nit=2, runs=(("raster", 128),), device="cpu",
                       out=str(out / "reorder.json"))
    perf_sweep.main(ms=(8,), nit=5, n=0, device="cpu",
                    out=str(out / "sweep.json"))
    profile_bcsr_build.main(cell=6, device="cpu",
                            out=str(out / "profile.json"))
    bler_tail_fix.main(cell=6, tail_zs=(8,), draw_seeds=(0,),
                       reround_attempts=10, device="cpu",
                       out=str(out / "fix.json"))
    assert set(os.listdir(REPO)) == before
    assert os.listdir(cwd) == []
    assert sorted(os.listdir(out)) == [
        "fix.json", "ml.json", "plateau.json", "profile.json",
        "reorder.json", "sweep.json", "z19.json"]
