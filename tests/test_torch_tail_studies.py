"""Port parity of the three 100k quality studies
(``sig_sdp_mmw_torch/experiments/{conv_probe,bler_tail_fix,
bler_tail_sweep}.py``) against the JAX tools' own inner functions
(``tools/bler_tail_fix.py::run_case``, ``tools/bler_tail_sweep.py::run_one``
and ``tools/conv_probe.py``'s loop body; never a tool's ``main``, which
writes into the repo root), at small cells on the CPU, through the kernels'
plain versions, with the JAX package's draws:

* conv_probe at cell 16 (K=768; Z = lb + 4, D_pad 32; nit 10 in two
  segments): the segmented solve's ub at each segment's end equals the
  tool's to 1e-4 in bf16 and in float32 blocks (the standard of
  ``tests/test_ell.py:111-125`` for shared draws); the port's flat operand
  against the tool's block-ELL one;
* bler_tail_fix at cell 12 (K=432), nit 20, with ``tail_margin_z=8`` (the state
  with the margin): the same probes (Z and remainder), each probe's ub to
  1e-4 (beside the tool's rounding to 3 decimals), the same Z_fin,
  verified; the BLER statistics, of two feasible assignments that may put
  a few users in other slots (the greedy scan orders near-equal inner
  products of factors that differ in float32 noise, and torch's thread
  count moves that noise), to 0.01 in the tail share and 10% in the mean;
* bler_tail_sweep at cell 12, ratio 0.1, nit 10: the same probe sequence,
  Z, remainder 0, verified, the same nnz, degS and state MB, the tail share
  equal and the mean BLER to rtol 1e-4;

Cells 12-16 and the short solves keep the file under a minute on one
core: a port probe at cell 24 and nit 60 takes about 9 s through the plain
versions, 3 s at cell 12.
* last, no study writes outside ``--out`` (or its run directory): each
  entry point run at a tiny size in an empty working directory leaves the
  repo root and that directory as they were, but for its own output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.experiments import (bler_tail_fix, bler_tail_sweep,
                                           conv_probe)
from sig_sdp_mmw_torch.models import mmw_ell as tm
from torch_jax_parity import REPO, JaxDraws, script
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)



def tool(name):
    return script("tools", name)


@pytest.mark.parametrize("tag", ["bf16", "f32"])
def test_conv_probe_matches_the_tool(tag):
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr as t_slim
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state as t_ops
    from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr as j_slim
    from sig_sdp_mmw_tpu.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                mmw_solve_ell)
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state as j_ops

    cell, nit, seg, eta = 16, 10, 5, 0.04
    S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0)
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 4)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    # The tool's loop body (tools/conv_probe.py:41-62), float32 in JAX.
    with jax.enable_x64(False):
        dt = jnp.bfloat16 if tag == "bf16" else np.float32
        ops = j_ops(S, Q, block=128, dtype=dt, store_transpose=True)
        slim = j_slim(S, Q, h)
        kw = dict(nit=nit, eta=eta, D_pad=D_pad, rank_pad=D_pad, lanczos_m=8)
        key = jax.random.PRNGKey(0)
        c, want = None, []
        for i0 in range(0, nit, seg):
            c = mmw_solve_ell(slim, Z, key=key, bcsr=ops, carry_in=c,
                              it_start=i0, num_steps=seg, return_carry=True,
                              **kw)
            want.append([i0 + seg, float(mmw_ell_ub_from_carry(
                slim, Z, c, i0 + seg))])
    got = conv_probe.probe_curve(
        t_slim(S, Q, h), t_ops(S, Q, block=128, dtype=conv_probe.DTYPES[tag],
                               store_transpose=True, flat_group=8),
        Z, nit=nit, seg=seg, eta=eta, D_pad=D_pad,
        draws=JaxDraws(jax.random.PRNGKey(0), nit))
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([u for _, u in got], [u for _, u in want],
                               rtol=0, atol=1e-4)


def test_bler_tail_fix_matches_the_tool():
    cell, tail_z, nit = 12, 8, 20
    with jax.enable_x64(False):
        want = tool("bler_tail_fix").run_case(jax, cell, tail_z, nit=nit)
    key = jax.random.PRNGKey(3)

    def draws(role, Z):
        if role == "solve":
            return JaxDraws(jax.random.fold_in(key, Z), nit=nit)
        return JaxDraws(jax.random.fold_in(key, 99 + Z), nattempt=6)

    got = bler_tail_fix.run_case(cell, tail_z, nit=nit, device="cpu",
                                 draws=draws)
    assert [(p["Z"], p["rem"]) for p in got["probes"]] == \
        [(p["Z"], p["rem"]) for p in want["probes"]]
    # The tool rounds each probe's ub to 3 decimals.
    np.testing.assert_allclose([p["ub"] for p in got["probes"]],
                               [p["ub"] for p in want["probes"]], rtol=0,
                               atol=5e-4 + 1e-4)
    assert (got["K"], got["lb"], got["Z_fin"]) == \
        (want["K"], want["lb"], want["Z_fin"])
    assert got["verified"] == {"ok": True, "interf": 0, "asso": 0}
    assert abs(got["frac_above_1e5"] - want["frac_above_1e5"]) <= 0.01
    np.testing.assert_allclose(got["bler_mean"], want["bler_mean"], rtol=0.1)


def test_bler_tail_sweep_matches_the_tool(monkeypatch):
    args = (0.1, 12, 75e-4, 0, 10, 0.05, 10, 128)
    with jax.enable_x64(False):
        want = tool("bler_tail_sweep").run_one(*args)
    monkeypatch.setattr(tm, "TorchDraws", lambda seed, device, stream: (
        JaxDraws(jax.random.fold_in(jax.random.PRNGKey(seed), stream),
                 nit=10, nattempt=10)))
    got = bler_tail_sweep.run_one(*args, device="cpu")
    for k in ("K", "nnz_S", "degS", "Z", "rem", "verified"):
        assert got[k] == want[k], k
    assert got["rem"] == 0 and got["verified"]["ok"]
    assert abs(got["state_mb"] - want["state_mb"]) <= 0.05
    assert got["frac_above_1e-5"] == want["frac_above_1e-5"]
    # The BLER to test_torch_dense_env.py's rtol 1e-4 (the port evaluates
    # in float64, JAX in float32).
    np.testing.assert_allclose(got["bler_mean"], want["bler_mean"],
                               rtol=1e-4)


def test_studies_write_only_their_outputs(tmp_path, monkeypatch):
    from sig_sdp_mmw_torch.experiments import (oracle_z_diagnose,
                                               sim_mmw_oracle_z)
    oracle_z_pair = script("port_studies", "oracle_z_pair")

    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = set(os.listdir(REPO))
    out = tmp_path / "out"
    out.mkdir()
    conv_probe.main(cell=6, nit=4, seg=2, dtypes=("f32",), device="cpu",
                    out=str(out / "conv.json"))
    bler_tail_fix.main(cell=6, tail_zs=(None,), device="cpu",
                       out=str(out / "fix.json"))
    bler_tail_sweep.main(["--cell", "6", "--ratios", "0.1", "--nit", "4",
                          "--device", "cpu", "--out",
                          str(out / "sweep.json")])
    run = out / "oz"
    sim_mmw_oracle_z.main(["--cells", "3", "--repeat", "1", "--oracle_nit",
                           "5", "--mmw_nit", "5", "--device", "cpu",
                           "--out", str(run)])
    oracle_z_diagnose.main([str(run), "--cell", "3", "--device", "cpu"])
    oracle_z_pair.main(["--run", f"a={run}", "--run", f"b={run}", "--cell",
                        "3", "--out", str(out / "pair.md")])
    assert set(os.listdir(REPO)) == before
    assert os.listdir(cwd) == []
    assert sorted(os.listdir(out)) == ["conv.json", "fix.json", "oz",
                                       "pair.json", "pair.md", "sweep.json"]
    assert {"oracle_z_diagnose.md", "oracle_z_diagnose.json"} <= set(
        os.listdir(run))


def test_launch_counts_are_read_by_route(monkeypatch):
    """The studies' launch counts are the wrappers' own by route
    (``route_launches``, counted where each kernel launches): a launch on
    another route than the operands' shows as that route, and a route or
    kernel that did not launch is left out."""
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.ops import bcsr as tb

    monkeypatch.setattr(tb.bsr_spmm_flat, "route_launches", {"ring": 5})
    monkeypatch.setattr(tb.bcsr_spmm, "route_launches",
                        {"ring": 2, "short_f32": 1})
    snap = launch_snapshot()
    tb.bsr_spmm_flat.route_launches["ring"] += 3
    tb.bsr_spmm_flat.route_launches["ring_f32"] = 4
    tb.bcsr_spmm.route_launches["short_f32"] += 2
    assert launches_since(snap) == {
        "bsr_spmm_flat": {"ring": 3, "ring_f32": 4},
        "bcsr_spmm": {"short_f32": 2}}
    assert launches_since(launch_snapshot()) == {}
