"""The two ensemble quality studies of the port
(sig_sdp_mmw_torch.experiments.oracle_z_report and gap_c15_sweep) against
the repo's JAX-side tools on the same rows, and their resumable scripts at
a small cell on the CPU.

``tools/oracle_z_report.py`` writes ``ORACLE_Z.md`` into its module-level
``REPO``; it is called only with ``REPO`` patched to a temporary directory.
``tools/merge_gap_c15.py`` is imported for its ``summarize`` alone (its
``main`` rewrites ``GAP_FULLSPEC.json``)."""

import csv
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from sig_sdp_mmw_torch.experiments import gap_c15_sweep, oracle_z_report
from sig_sdp_mmw_torch.experiments import sim_mmw_oracle_z
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_rows(path, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


def _oracle_rows(d, seed, cell=10):
    """scs/mmw150/rand files with some remainders, one seed written twice
    and one seed missing from one file."""
    rng = np.random.default_rng(seed)
    K = 3 * cell * cell
    Z = {s: int(rng.integers(9, 14)) for s in range(25)}
    for name, p_rem in (("scs", 0.05), ("mmw150", 0.15), ("rand", 0.45)):
        rows = []
        for s in range(25):
            if name == "rand" and s == 7:
                continue
            for _ in range(2 if s == 3 else 1):
                rem = int(rng.integers(1, 4)) if rng.random() < p_rem else 0
                rows.append([0, s, Z[s], rem]
                            + list(10 ** rng.uniform(-9, -1, K)))
        _write_rows(d / f"{name}-{cell}-75", rows)


def _stat_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(("- ", "| "))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_report_matches_tool(tmp_path, monkeypatch, seed):
    run = tmp_path / "run"
    run.mkdir()
    _oracle_rows(run, seed)
    tool = _tool("oracle_z_report")
    monkeypatch.setattr(tool, "REPO", str(tmp_path))
    tool.main(str(run))
    want = (tmp_path / "ORACLE_Z.md").read_text()

    s = oracle_z_report.main([str(run), "--out", str(tmp_path / "port.md")])
    got = (tmp_path / "port.md").read_text()
    assert _stat_lines(got) == _stat_lines(want)
    assert len(_stat_lines(want)) == 8
    assert s["n"] == 24 and 7 not in s["seeds"]
    saved = json.loads((tmp_path / "oracle_z_report.json").read_text())
    assert saved["Z"] == s["Z"]


def test_oracle_report_default_goes_to_the_run_dir(tmp_path):
    _oracle_rows(tmp_path, 4)
    oracle_z_report.main([str(tmp_path)])
    assert (tmp_path / "ORACLE_Z.md").stat().st_size > 0
    assert (tmp_path / "oracle_z_report.json").exists()


def _gap_rows(path, seed, nseeds, nit):
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(nseeds):
        rows.append([0, s] + list(rng.uniform(0.1, 0.4, nit)))
        rows.append([0, s] + list(rng.uniform(-2.5, -1.0, nit)))
    _write_rows(path, rows)


@pytest.mark.parametrize("nseeds,nit", [(1, 5), (12, 100), (20, 2500)])
def test_gap_summarize_matches_tool(tmp_path, nseeds, nit):
    path = tmp_path / "mmw-dual-15-2"
    _gap_rows(path, nseeds, nseeds, nit)
    assert (gap_c15_sweep.summarize(str(path))
            == _tool("merge_gap_c15").summarize(str(path)))


_SMALL = ["--device", "cpu"]


def test_gap_sweep_resumes_between_seeds(tmp_path, monkeypatch):
    """The sweep at cell 3 (K=27), two etas, a short oracle."""
    monkeypatch.setattr(gap_c15_sweep, "CELL", 3)
    monkeypatch.setattr(gap_c15_sweep, "ETAS", [0.2, 0.3])
    monkeypatch.setattr(gap_c15_sweep, "ORACLE_NIT", 30)
    out = str(tmp_path / "gap")
    gap_c15_sweep.main(["--seeds", "1", "--out", out] + _SMALL)
    gap_c15_sweep.main(["--seeds", "2", "--out", out] + _SMALL)
    gap_c15_sweep.main(["--seeds", "3", "--budget_s", "0", "--out", out]
                       + _SMALL)
    summary = json.loads((tmp_path / "gap" / gap_c15_sweep.SUMMARY)
                         .read_text())["series"]
    assert sorted(summary) == ["mmw-dual-3-20", "mmw-dual-3-30"]
    for name, nit in (("mmw-dual-3-20", 25), ("mmw-dual-3-30", 12)):
        with open(tmp_path / "gap" / name) as f:
            rows = list(csv.reader(f))
        assert [int(r[1]) for r in rows] == [0, 0, 1, 1]
        assert all(len(r) == 2 + nit for r in rows)
        assert summary[name]["n_seeds"] == 2
        assert summary[name] == gap_c15_sweep.summarize(
            str(tmp_path / "gap" / name))


def test_oracle_study_resumes_and_reports(tmp_path):
    out = str(tmp_path / "oz")
    args = ["--cells", "3", "--oracle_nit", "30", "--mmw_nit", "20",
            "--device", "cpu", "--out", out]
    sim_mmw_oracle_z.main(["--repeat", "1"] + args)
    sim_mmw_oracle_z.main(["--repeat", "2"] + args)
    for name in ("scs", "mmw150", "rand"):
        with open(tmp_path / "oz" / f"{name}-3-75") as f:
            assert [int(r[1]) for r in csv.reader(f)] == [0, 1]
    s = oracle_z_report.main([out, "--cell", "3"])
    assert s["n"] == 2 and s["oracle_feasible"] == 1.0
