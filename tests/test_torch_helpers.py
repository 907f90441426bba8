"""Port parity: the small helpers (stats, logging aliases, the native thread
count, the user samplers, the speed of light) against the JAX package.

``save_np`` must write the same files, ``_moving_average`` give the same
sequence, ``p_true`` the same draws after ``np.random.seed``.  The samplers
take a ``torch.Generator`` where JAX takes a key, and torch cannot replay
``jax.random``: they are held to their invariants (shape, range, unit norm,
the same draws from the same generator state)."""

import os
import time

import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.env import phy as jphy
from sig_sdp_mmw_tpu.utils import logging as jlog
from sig_sdp_mmw_tpu.utils import stats as jstats
from sig_sdp_mmw_torch.env import env as tenv
from sig_sdp_mmw_torch.env import phy as tphy
from sig_sdp_mmw_torch.native.builder import native_num_threads
from sig_sdp_mmw_torch.utils import logging as tlog
from sig_sdp_mmw_torch.utils import stats as tstats
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def _logger(mod):
    class Logged(mod.STATS_OBJECT):
        pass
    obj = Logged()
    for step in range(4):
        obj._add_np_log("gap", step, [0.5 * step, -1.0 / (step + 1)])
        obj._add_np_log("rem", step, step % 3, g_step=7)
    return obj


@pytest.mark.parametrize("class_name", [None, "MMW"])
def test_save_np_writes_the_jax_files(tmp_path, monkeypatch, class_name):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    out = {}
    for tag, mod in (("jax", jstats), ("torch", tstats)):
        obj = _logger(mod)
        obj.LOGGED_CLASS_NAME = class_name
        obj.save_np(str(tmp_path / tag), "run0")
        out[tag] = {f: (tmp_path / tag / f).read_bytes()
                    for f in sorted(os.listdir(tmp_path / tag))}
    assert out["torch"] == out["jax"]
    assert len(out["jax"]) == 2


@pytest.mark.parametrize("window", [1, 3, 100])
def test_moving_average_matches_jax(window):
    vals = np.random.default_rng(window).standard_normal(12)
    seqs = []
    for mod in (jstats, tstats):
        obj = mod.StatsObject()
        obj.MOVING_AVERAGE_TIME_WINDOW = window
        seqs.append([obj._moving_average(k, v) for v in vals
                     for k in ("a", "b")])
    assert seqs[0] == seqs[1]


def test_debug_prints_match_jax(capsys):
    outs = []
    for mod in (jstats, tstats):
        obj = mod.StatsObject()
        obj._print("silent")
        obj.status()
        obj._debug(True, debug_step=4)
        for step in range(9):
            obj.N_STEP = step
            obj._print("step", step, 0.5)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].count("step") == 7


@pytest.mark.parametrize("prob", [0.0, 0.3, 0.9])
def test_p_true_follows_numpy_global_stream(prob):
    draws = []
    for mod in (jstats, tstats):
        np.random.seed(11)
        draws.append([mod.p_true(prob) for _ in range(50)])
    assert draws[0] == draws[1]


def test_db_ratio_helpers_match_jax():
    x = np.array([-30.0, 0.0, 3.0, 17.5])
    r = tstats.db_to_ratio(x)
    np.testing.assert_array_equal(r, jstats.db_to_ratio(x))
    np.testing.assert_array_equal(tstats.ratio_to_db(r), jstats.ratio_to_db(r))
    assert tstats.DbToRatio is tstats.db_to_ratio
    assert tstats.RatioToDb is tstats.ratio_to_db


def test_plot_a_array_matches_jax(tmp_path):
    arr = np.random.default_rng(2).standard_normal(60)
    got = tstats.plot_a_array(arr, mavg_n=5, name="curve",
                              save_path=str(tmp_path))
    np.testing.assert_array_equal(got, jstats.plot_a_array(arr, mavg_n=5))
    figs = os.listdir(tmp_path / "saved_figures")
    assert len(figs) == 1 and figs[0].startswith("curve-")
    assert (tmp_path / "saved_figures" / figs[0]).stat().st_size > 0


def test_logging_aliases():
    assert tlog.CSV_WRITER_OBJECT is tlog.CsvWriter
    assert tlog.GET_LOG_PATH_FOR_SIM_SCRIPT is tlog.get_log_path_for_sim_script
    assert tlog.GET_FILE_NAME_FOR_SIM_SCRIPT is tlog.get_file_name_for_sim_script
    assert (tlog.GET_FILE_NAME_FOR_SIM_SCRIPT("/a/b/sim_x.py")
            == jlog.GET_FILE_NAME_FOR_SIM_SCRIPT("/a/b/sim_x.py"))


def test_native_num_threads():
    assert native_num_threads() >= 1


def test_c_light_matches_jax():
    assert tphy.C_LIGHT == jphy.C_LIGHT


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sample_sta_locs_invariants(dtype):
    p = tenv.EnvParams(cell_size=6, sta_density_per_1m2=75e-4)
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    a = tenv.sample_sta_locs(g, p, dtype=dtype)
    assert a.shape == (p.n_sta, 2) and a.dtype == dtype
    assert float(a.min()) >= 0.0 and float(a.max()) < p.grid_edge
    g.set_state(state)
    assert torch.equal(tenv.sample_sta_locs(g, p, dtype=dtype), a)
    assert not torch.equal(tenv.sample_sta_locs(g, p, dtype=dtype), a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sample_sta_dirs_invariants(dtype):
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    d = tenv.sample_sta_dirs(g, 200, dtype=dtype)
    assert d.shape == (200, 2) and d.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(torch.linalg.norm(d, dim=1),
                               torch.ones(200, dtype=dtype), rtol=0, atol=tol)
    # Headings cover every quadrant.
    assert len({(bool(x > 0), bool(y > 0)) for x, y in d.tolist()}) == 4
    g.set_state(state)
    assert torch.equal(tenv.sample_sta_dirs(g, 200, dtype=dtype), d)
