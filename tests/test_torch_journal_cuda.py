"""The journal comparison slice on the card against the same calls on the
CPU, with the same draws (made on the CPU and moved), float64 on the K=75
fixture: the ADMM oracle (X_final to 1e-7 of its max, the factor's Gram
where the rank cut lies in a spectral gap), LRP (P to 1e-8 of its max, the
rounding of one P equal), Rand and Spectral (factor and projector), the
greedy heuristics (equal assignments; MAX_GAIN on the CPU's scores, whose
ties each device's summation breaks in its own way), and ``sim_all_bler``
end to end on ``--device cuda``.

This file imports no jax, so it runs on a CUDA machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_journal_cuda.py -m cuda
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.core.problem import state_from_arrays
from sig_sdp_mmw_torch.models import admm, baselines, heuristics, lrp
from sig_sdp_mmw_torch.models.rounding import verify_assignment
from sig_sdp_mmw_torch.utils.draws import TorchDraws

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


class CpuDrawsOn:
    """TorchDraws made on the CPU and moved to ``device``."""

    def __init__(self, seed, device):
        self.base = TorchDraws(seed, "cpu")
        self.device = device

    def __getattr__(self, role):
        fn = getattr(self.base, role)
        return lambda *a: fn(*a).to(self.device)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _states():
    fix = np.load(FIXTURES / "mmw_small.npz")
    return [state_from_arrays(fix["S"], fix["Q"], fix["h_max"],
                              dtype=torch.float64, device=d)
            for d in ("cpu", "cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("nit", [30, 100])
def test_admm_on_card_matches_cpu(nit):
    _need_card()
    out = [admm.admm_sdp_solve(st, 6.0, nit=nit, rank_pad=32, rank_radio=3)
           for st in _states()]
    (Hc, Xc), (Hg, Xg) = [(H.cpu().numpy(), X.cpu().numpy())
                          for H, X in out]
    np.testing.assert_allclose(Xg, Xc, rtol=0, atol=1e-7 * np.abs(Xc).max())
    np.testing.assert_allclose(Hg @ Hg.T, Hc @ Hc.T, rtol=0, atol=1e-7)


@pytest.mark.cuda
def test_lrp_on_card_matches_cpu():
    _need_card()
    sc, sg = _states()
    Pc = lrp.lrp_solve(sc, 10.0, nit=50, Z_pad=48)
    Pg = lrp.lrp_solve(sg, 10.0, nit=50, Z_pad=48)
    np.testing.assert_allclose(Pg.cpu().numpy(), Pc.numpy(), rtol=0,
                               atol=1e-8 * float(Pc.abs().max()))
    zc, rc = lrp._lrp_round(sc, Pc, 10, CpuDrawsOn(3, "cpu"), Z_pad=48)
    zg, rg = lrp._lrp_round(sg, Pc.cuda(), 10, CpuDrawsOn(3, "cuda"),
                            Z_pad=48)
    assert rg == rc
    np.testing.assert_array_equal(zg.cpu().numpy(), zc.numpy())


@pytest.mark.cuda
def test_rand_and_spectral_on_card_match_cpu():
    _need_card()
    sc, sg = _states()
    gc = baselines.rand_factor(sc, 8, 2, CpuDrawsOn(0, "cpu"))
    gg = baselines.rand_factor(sg, 8, 2, CpuDrawsOn(0, "cuda"))
    np.testing.assert_allclose(gg.cpu().numpy(), gc.numpy(), rtol=0,
                               atol=1e-12)
    vc, wc = baselines._subspace_topk(baselines.laplacian(sc),
                                      CpuDrawsOn(0, "cpu"), k=8)
    vg, wg = baselines._subspace_topk(baselines.laplacian(sg),
                                      CpuDrawsOn(0, "cuda"), k=8)
    vc, vg = vc.numpy(), vg.cpu().numpy()
    np.testing.assert_allclose(wg.cpu().numpy(), wc.numpy(), rtol=0,
                               atol=1e-8 * float(wc.abs().max()))
    np.testing.assert_allclose(vg @ vg.T, vc @ vc.T, rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["MAX_GAIN", "MAX_ASSO", "MAX_RAND"])
def test_heuristics_on_card_match_cpu(cls, monkeypatch):
    _need_card()
    sc, sg = _states()
    h = getattr(heuristics, cls)
    if cls == "MAX_GAIN":
        scores = h._scores(sc)
        monkeypatch.setattr(h, "_scores",
                            classmethod(lambda c, st: scores.to(st.S.device)))
    seed = 4242 if cls == "MAX_RAND" else 777
    for Z in (6, 8):
        zc, Zc, rc = h.run(Z, sc, draws=CpuDrawsOn(seed, "cpu"))
        zg, Zg, rg = h.run(Z, sg, draws=CpuDrawsOn(seed, "cuda"))
        assert (Zg, rg) == (Zc, rc)
        np.testing.assert_array_equal(zg, zc)
        if rg == 0:
            assert verify_assignment(sc, zg)[0]


@pytest.mark.cuda
def test_sim_all_bler_on_card(tmp_path):
    _need_card()
    from sig_sdp_mmw_torch.experiments import sim_all_bler

    out = str(tmp_path / "bler")
    path = sim_all_bler.main(["--smoke", "--cells", "3", "--device", "cuda",
                              "--out", out])
    names = sorted(os.listdir(path))
    assert names == ["checkpoint.jsonl", "ladmm-3-75", "masso-3-75",
                     "mgain-3-75", "mmw-3-75", "rand-3-75"]
    for name in names[1:]:
        with open(os.path.join(path, name)) as f:
            row = np.array(f.read().strip().split(",")[2:], float)
        assert row.size == 1 + 27 and np.all(np.isfinite(row))
