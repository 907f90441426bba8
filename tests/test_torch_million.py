"""The million-link entry point (sig_sdp_mmw_torch.experiments.
million_link_e2e) driven at cell 10 (K=300) on the CPU against the JAX tool
(tools/million_link_e2e.py) on the same instance and settings, and the
entry points' refusal to leave the card unasked.

The two packages draw different random numbers, so the slot counts may
differ by the rounding's luck: Z_fin within 1.  The JAX tool writes its
assignment beside the repository's records; the test sends that write to a
temporary directory and checks the records are untouched."""

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.experiments import million_link_e2e as ml
from sig_sdp_mmw_torch.experiments.e2e_large import main as e2e_main
from sig_sdp_mmw_torch.utils.tensors import resolve_device
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(cell=10, nit_probe=20, nit_conv=30, segment=5, row_chunk=2,
             skip_bler=True)
RECORDS = ("MILLION_LINK_E2E.json", "million_link_e2e_assignment.npz")


def _digest(name):
    with open(os.path.join(REPO, name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ml") / "run.json")
    return ml.main(**SMALL, out_path=out, device="cpu"), out


def test_million_link_entry_point_small_is_feasible(port_run):
    rec, out = port_run
    assert rec["K"] == 300 and rec["operand_devices"] == ["cpu"]
    assert rec["remainder"] == 0 and rec["verified_feasible"]
    assert rec["n_interf_vio"] == 0 and rec["n_asso_vio"] == 0
    assert [p["Z"] for p in rec["probes"]][0] == rec["lb"] + 4
    assert rec["conv_curve"][-1][0] == SMALL["nit_conv"]
    assert rec["conv_curve"][-1][1] == pytest.approx(rec["ub_final"],
                                                     abs=1e-6)
    with open(out) as f:
        assert json.load(f)["Z_fin"] == rec["Z_fin"]
    z = np.load(out.replace(".json", "_assignment.npz"))
    assert int(z["Z"]) == rec["Z_fin"] and z["z_vec"].shape == (300,)


def test_million_link_matches_jax_tool(port_run, tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "million_link_e2e_tool", os.path.join(REPO, "tools",
                                              "million_link_e2e.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    before = [_digest(n) for n in RECORDS]
    savez = np.savez_compressed
    monkeypatch.setattr(np, "savez_compressed", lambda path, **kw: savez(
        str(tmp_path / os.path.basename(path)), **kw))
    jrec = tool.main(**SMALL, out_path=str(tmp_path / "jax.json"))
    monkeypatch.undo()
    assert [_digest(n) for n in RECORDS] == before
    rec = port_run[0]
    assert jrec["K"] == rec["K"] and jrec["lb"] == rec["lb"]
    assert jrec["final"]["rem"] == 0
    assert abs(rec["Z_fin"] - jrec["Z_fin"]) <= 1


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """device='cuda' (the default) without a card raises before any work;
    the CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: e2e_main(cell=10), lambda: ml.main(cell=10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert resolve_device("cpu").type == "cpu"
