"""The port's profiling hooks (sig_sdp_mmw_torch.utils.profiling, the
counterpart of sig_sdp_mmw_tpu.utils.profiling): the cProfile decorator
behind its enabler, and the names ``annotate`` gives a ``device_trace``,
the sharded operator's spans among them.  No tolerances."""

import json

import numpy as np
import torch

from sig_sdp_mmw_torch.core.ell import ell_from_sig_state
from sig_sdp_mmw_torch.core.problem import state_from_arrays
from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
from sig_sdp_mmw_torch.parallel.mesh import MeshAxis
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.profiling import (GLOBAL_PROF_ENABLER, annotate,
                                               device_trace, profile)


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
