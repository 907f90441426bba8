"""Port parity: the figure renderer (sig_sdp_mmw_torch.experiments.
plot_results vs sig_sdp_mmw_tpu.experiments.plot_results).

One synthetic CSV directory holds every metric family the module
recognises. Both packages render it, each into its own directory, and a
wrapper around ``matplotlib.figure.Figure.savefig`` records every axis's
line, collection and image data before each save. The two packages must
write the same files with the same arrays, to 1e-12."""

import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
from matplotlib.figure import Figure  # noqa: E402

from sig_sdp_mmw_tpu.experiments import plot_results as jpr  # noqa: E402
from sig_sdp_mmw_torch.experiments import plot_results as tpr  # noqa: E402
from torch_jax_parity import one_torch_thread  # noqa: F401,E402  (autouse)

FIGURES = ["bler_avg_max.pdf", "bler_cdf.pdf", "duality_gap.pdf",
           "duality_gap_heatmap.pdf", "conv-rho.pdf", "conv-alp.pdf",
           "solve_time_vs_K.pdf", "online_bler.pdf", "graph_stats.pdf",
           "matrix_sparsity.pdf"]
SPARSITY_CELLS = (3, 5)   # the JAX function indexes a 2-D grid of axes


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(repr(float(v)) for v in r) + "\n")


def _synthetic_dir(d):
    """Every metric family plot_results reads, with seeded values."""
    rng = np.random.default_rng(0)
    for method in ("mmw", "rand"):
        for cell in (5, 10):
            K = 3 * cell * cell
            _write(d / f"{method}-{cell}-75",
                   [[0, s, 9 + s] + list(10 ** rng.uniform(-9, -1, K))
                    for s in range(2)])
    for cell in (5, 10):
        for eta in (2, 4, 10):
            rows = []
            for s in range(3):
                t = np.arange(1, 40)
                rows.append([0, s] + list(0.2 + 1.0 / t + rng.uniform(0, .01)))
                rows.append([0, s] + list(-1.5 + 0.1 * np.log(t)))
            _write(d / f"mmw-dual-{cell}-{eta}", rows)
    for tag in ("rho", "alp"):
        for v in (1, 5):
            _write(d / f"conv-{tag}-{v}-75",
                   [[0, s] + list(rng.uniform(0.1, 1.0, 25))
                    for s in range(2)])
    for name in ("mmw", "scs"):
        _write(d / f"{name}-time-10-75",
               [[0, s, K, 12, rng.uniform(1e5, 1e7)] for s in range(3)
                for K in (75, 300, 675)])
    for method in ("mmw", "rand"):
        for step in (0, 1, 4):
            _write(d / f"online-{method}-{step}-150-5-75",
                   [[0, s] + list(10 ** rng.uniform(-8, -2, 75))
                    for s in range(2)])
    for rho in (50, 75):
        for cell in (5, 10, 15):
            _write(d / f"graph-{cell}-{rho}",
                   [[0, s, 3 * cell * cell, rng.uniform(5, 9),
                     rng.uniform(10, 30)] for s in range(2)])
    (d / "checkpoint.jsonl").write_text('{"item": "cell5", "seed": 0}\n')
    (d / "notes").write_text("not,a,metric\n")


def _axis_data(fig):
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xydata(), dtype=np.float64))
        for coll in ax.collections:
            out.append(np.asarray(coll.get_offsets(), dtype=np.float64))
        for im in ax.get_images():
            out.append(np.ma.filled(np.asarray(im.get_array(),
                                               dtype=np.float64), np.nan))
    return out


def _render(mod, data_dir, out_dir, monkeypatch):
    captured = {}
    orig = Figure.savefig

    def savefig(self, fname, *a, **kw):
        captured[os.path.basename(fname)] = _axis_data(self)
        return orig(self, fname, *a, **kw)

    monkeypatch.setattr(Figure, "savefig", savefig)
    mod.main([str(data_dir), "--out", str(out_dir)])
    mod.plot_matrix_sparsity(str(out_dir), cells=SPARSITY_CELLS)
    monkeypatch.undo()
    return captured


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    _synthetic_dir(data)
    out = {}
    for tag, mod in (("jax", jpr), ("torch", tpr)):
        d = tmp_path_factory.mktemp(tag)
        with pytest.MonkeyPatch.context() as mp:
            out[tag] = (_render(mod, data, d, mp), d)
    return out


def test_same_figure_files(rendered):
    (jcap, jdir), (tcap, tdir) = rendered["jax"], rendered["torch"]
    assert sorted(tcap) == sorted(jcap) == sorted(FIGURES)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in FIGURES:
        assert (tdir / name).stat().st_size > 0


@pytest.mark.parametrize("name", FIGURES)
def test_figure_data_matches_jax(rendered, name):
    want = rendered["jax"][0][name]
    got = rendered["torch"][0][name]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_sparsity_at_one_cell(tmp_path):
    tpr.plot_matrix_sparsity(str(tmp_path), cells=(5,))
    assert (tmp_path / "matrix_sparsity.pdf").stat().st_size > 0
