"""The port's top-level entry points (sig_sdp_mmw_torch.entry: entry() and
dryrun_multichip(), the counterparts of __graft_entry__.py) and the
sharded block solve at a small size (experiments/sharded_large.py), on the
CPU over gloo ranks.

Tolerances: entry() against the JAX entry with the JAX draws, float32,
|Δub| <= 1e-5 * |ub|; the dryrun and sharded_large hold their own checks
(rem 0, verification, every rank the same bits, |Δub| and the
sign-aligned max|ΔX_half| below 1e-3 against one process)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from sig_sdp_mmw_torch import entry as tentry
from sig_sdp_mmw_torch.experiments import sharded_large
from torch_jax_parity import JaxDraws
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def test_tiny_state_matches_jax():
    js, ts = jentry._tiny_state(), tentry._tiny_state()
    assert ts.K == js.K == 24 and ts.Kp == 32
    for name in ("S", "Q", "h_max", "mask"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))


def test_entry_runs_on_the_cpu_and_matches_jax():
    fn, args = tentry.entry(device="cpu")
    state, Z, draws = args
    X_half, ub = fn(*args)
    assert X_half.shape == (state.Kp, 16) and torch.isfinite(X_half).all()
    assert np.isfinite(float(ub))
    jfn, jargs = jentry.entry()
    _, ub_j = jax.jit(jfn)(*jargs)
    _, ub_t = fn(state, Z, JaxDraws(jargs[2], 4))
    assert abs(float(ub_t) - float(ub_j)) <= 1e-5 * abs(float(ub_j))


def test_entry_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_multichip_4_on_the_cpu(capsys):
    rec = tentry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh={'batch': 2, 'graph': 2}" in line
    assert "rem=[0 0]" in line and "sparse_rem=0" in line
    assert rec["backend"] == "gloo" and rec["rems"] == [0, 0]
    assert rec["verified"] == [True, True] and rec["sparse_rem"] == 0
    assert rec["collective_bytes"] > 0
    assert rec["operand_devices"] == ["cpu"]
    assert len(rec["launches_per_rank"]) == 4


@pytest.mark.parametrize("graph", [1, 2])
def test_sharded_large_small_cell(tmp_path, graph):
    out = tmp_path / "sharded.json"
    rec = sharded_large.main(cell=6, nit=5, block=8, graph=graph,
                             layouts=("f32_ell", "bf16_flat"), device="cpu",
                             backend="gloo", out=str(out))
    assert json.loads(out.read_text())["K"] == rec["K"]
    assert os.listdir(tmp_path) == ["sharded.json"]
    for layout in ("f32_ell", "bf16_flat"):
        r = rec[layout]
        assert r["equal"] and r["ranks_bit_equal"], r
        assert r["rounding_rem"] == 0 and r["verified"]["ok"]
        assert len(r["bytes_per_rank_mb"]) == graph and r["balance"] > 0.5
        if graph == 1:
            assert r["bit_equal_single"]
        else:
            assert r["collective_mb_per_solve"] > 0
            assert r["rows_per_rank"] == [[0, rec["rows_padded"] // 16],
                                          [rec["rows_padded"] // 16,
                                           rec["rows_padded"] // 8]]
