"""The million-link cell ``sig1m.probe`` on the CPU at a tiny size,
through the harness with its look for a card skipped: the result line and
its metrics, the faults each check has to catch, the two controls.  The
card's own run at full size is the ``cuda``-marked test at the end."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.reference.state import large_state, params_of
from portbench.tests.test_portbench_runs import (  # noqa: F401
    CHECKS, _assoc_pair, one_thread)

CELL = "sig1m.probe"
SEED = 2**31 + 5


def tiny_spec(cell_size=12, nit=10):
    spec = copy.deepcopy(harness.cell_spec(CELL))
    spec["config_file"]["scenario"]["cell_size"] = cell_size
    spec["config_file"]["solver"]["nit"] = nit
    return spec


def run(trace=False, hooks=None, seconds=1.0, spec=None):
    return harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                            spec=spec or tiny_spec(), hooks=hooks)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    """Correct, the six checks, every metric that is not the device's
    trace (the CPU has none); the bound checked at the smallest Z, by its
    three parts."""
    r = run(trace)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == CHECKS
    spec = harness.cell_spec(CELL)
    group = spec["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group if m["source"] != "device_trace"}
    assert want <= set(r["metrics"])
    assert ("probe_s" in want) != trace
    assert ("mmw_ell.ms_per_it.probe" in want) == trace
    for m in r["metrics"].values():
        assert np.isfinite(m["value"]) and m["value"] > 0
    assert r["info"]["ub_checked"][0][0] == min(r["info"]["probe_Z"])
    assert len(r["info"]["ub_parts"][0]) == 3


def _faults():
    p = params_of(tiny_spec()["config_file"])
    i, j = _assoc_pair(large_state(p, 0)[1])      # the network_seed's

    def share_slot(z, Z):
        z = np.array(z)
        z[j] = z[i]
        return z

    def half_left_out(z, Z):
        z = np.array(z)
        z[::2] = -1
        return z

    def stale(solve):
        first = []

        def again(it, Z, state):
            if not first:
                first.append(solve(it, Z, state))
            return first[0]

        return again

    return {"altered": {"answer": share_slot},
            "half": {"answer": half_left_out},
            "stale": {"solve": stale}}


@pytest.mark.parametrize("fault", ["altered", "half", "stale"])
def test_fault_comes_out_not_correct(fault):
    """Each fault planted under the timed path makes ``correct`` false."""
    r = run(hooks=_faults()[fault], seconds=4.0)
    assert r["attempted"] >= 2
    assert not r["correct"], r["checks"]


def test_control_products_comes_out_not_correct():
    """The reference's solve with its products in float8, in the port's
    place, at the configuration's depth (120 iterations), the window
    holding only the search's first probe, far above the answer (Z = 46
    of the degree window [8, 84]), where the bound itself barely moves with
    the products: the gap of the budgets' part fails."""
    spec = tiny_spec(12, harness.cell_spec(CELL)["config_file"]["solver"]
                     ["nit"])
    r = harness.run_cell(CELL, 3, 1.0, False, device="cpu", spec=spec,
                         hooks=control.hooks_for(spec, "products"))
    assert not r["correct"] and r["info"]["probe_Z"] == [46]
    c = r["checks"]["ub_gap"]
    assert c["value"] > c["limit"], c


def test_control_state_comes_out_not_correct():
    """The state in bfloat16, the precision below the configuration's."""
    spec = tiny_spec()
    r = harness.run_cell(CELL, 3, 1.0, False, device="cpu", spec=spec,
                         hooks=control.hooks_for(spec, "state"))
    assert not r["correct"]
    assert r["checks"]["state_rel_err"]["value"] > 1e-3


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the cell at its own size on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run_cell(CELL, 2**31 + 77, 2.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu", r["checks"]
