"""The benchmark's definition: ``BENCHMARK.json`` against its own rules,
every name found as a file, and the imports each part may make."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
PB = harness.PB_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for k in ("config", "traffic"):
            assert NAME.match(w[k]), w[k]
        names.append(w["name"])
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for m in bench[group]:
            assert set(m) <= keys and set(m) >= keys - {"workloads"}, m
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in bench[kind]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for g in ("end_to_end", "per_layer") for m in bench[g]]
    assert len(ms) == len(set(ms))
    for e in bench["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_every_cell_reports_what_its_metrics_move(bench):
    """Each cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric's cells report the end-to-end
    metric it moves."""
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    assert e2e["setup_s"] == cells
    for c in cells:
        assert any(c in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(c in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]


def test_harness_finds_everything_by_name(bench):
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"], bench)
        proto = harness.protocol(spec["workload"]["protocol"])
        for fn in ("setup", "window", "judge"):
            assert callable(getattr(proto, fn))
        assert spec["config_file"]["name"] == w["config"]
        assert set(spec["workload"]["checks"]) == {
            "state_rel_err", "overload", "broken", "rem_contradicted",
            "ub_gap", "search_mismatch"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(harness.metric_reader(m["name"]).read)


def test_configs_state_their_guarantees(bench):
    for c in bench["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["name"] == c["name"] and cfg["guarantees"]
        assert cfg["state_dtype"] == "float32"
        assert cfg["control_products"] in ("bfloat16", "float8_e4m3fn")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for root, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    """By whole top-level names: the port's own name begins with the JAX
    package's."""
    forbidden = set(harness.FORBIDDEN)
    files = list(_sources(PB))
    assert len(files) > 20
    for path in files:
        assert not set(_imports(path)) & forbidden, path
    for path in _sources(os.path.join(PB, "reference")):
        tops = set(_imports(path))
        assert "sig_sdp_mmw_torch" not in tops, path
        assert tops <= {"__future__", "dataclasses", "math", "numpy",
                        "scipy", "torch", "warnings", "portbench"}, (path,
                                                                tops)
