"""The dense path on the card against the same calls on the CPU, with the
same draws (made on the CPU and moved): the environment's state, the MMW
solve (the Gram X_half X_halfᵀ to 1e-8 of its max in float64, 1e-4 in
float32) and the rounding (z_vec and remainder equal, float64).

This file imports no jax, so it runs on a CUDA machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dense_cuda.py -m cuda
"""

import pathlib

import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.core.problem import state_from_arrays
from sig_sdp_mmw_torch.env import WirelessEnv
from sig_sdp_mmw_torch.models.mmw import mmw_solve
from sig_sdp_mmw_torch.models.rounding import rounding, verify_assignment
from sig_sdp_mmw_torch.utils.draws import TorchDraws

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


class CpuDrawsOn:
    """TorchDraws made on the CPU and moved to ``device``, so both devices
    see the same numbers."""

    def __init__(self, seed, device):
        self.base = TorchDraws(seed, "cpu")
        self.device = device

    def __getattr__(self, role):
        fn = getattr(self.base, role)
        return lambda *a: fn(*a).to(self.device)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _state(name, pad, dtype, device):
    fix = np.load(FIXTURES / f"{name}.npz")
    return state_from_arrays(fix["S"], fix["Q"], fix["h_max"], pad_to=pad,
                             dtype=dtype, device=device)


def _gram(X):
    X = X.double().cpu()
    return X @ X.T


@pytest.mark.cuda
@pytest.mark.parametrize("dt,rel", [("float64", 1e-8), ("float32", 1e-4)])
def test_dense_solve_on_card_matches_cpu(dt, rel):
    _need_card()
    dtype = getattr(torch, dt)
    kw = dict(nit=30, eta=0.05, D_pad=32, rank_pad=32, log_gap=True)
    out = {}
    for dev in ("cpu", "cuda"):
        st = _state("mmw_small", None, dtype, dev)
        out[dev] = mmw_solve(st, 8.0, draws=CpuDrawsOn(0, dev), **kw)
    assert out["cuda"].tensor_devices() == {"cuda"}
    Gc, Gg = _gram(out["cpu"].X_half), _gram(out["cuda"].X_half)
    assert float((Gg - Gc).abs().max()) <= rel * float(Gc.abs().max())
    assert abs(float(out["cuda"].ub_final) - float(out["cpu"].ub_final)) \
        <= rel * max(1.0, abs(float(out["cpu"].ub_final)))
    assert bool(torch.isfinite(out["cuda"].gap_log).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,pad,Z", [("mmw_small", None, 8),
                                        ("env_mid", 320, 11)])
def test_dense_rounding_on_card_matches_cpu(name, pad, Z):
    _need_card()
    st_cpu = _state(name, pad, torch.float64, "cpu")
    gX = mmw_solve(st_cpu, float(Z), nit=20, eta=0.05, D_pad=32, rank_pad=32,
                   draws=TorchDraws(2)).X_half
    res = {}
    for dev in ("cpu", "cuda"):
        st = st_cpu.to(dev)
        res[dev] = rounding(Z, gX.to(dev), st, CpuDrawsOn(5, dev))
    np.testing.assert_array_equal(res["cuda"][0], res["cpu"][0])
    assert res["cuda"][1:] == res["cpu"][1:]
    if res["cpu"][2] == 0:
        assert verify_assignment(st_cpu, res["cuda"][0])[0]


@pytest.mark.cuda
def test_env_on_card_matches_cpu():
    _need_card()
    fix = np.load(FIXTURES / "env_mid.npz")
    envs = {dev: WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075,
                             seed=3, pad_to=320, device=dev,
                             sta_locs=fix["sta_locs"])
            for dev in ("cpu", "cuda")}
    st = {dev: e.generate_S_Q_hmax() for dev, e in envs.items()}
    assert st["cuda"].tensor_devices() == {"cuda"}
    for k in ("S", "Q", "h_max", "mask"):
        a, b = getattr(st["cpu"], k), getattr(st["cuda"], k).cpu()
        assert torch.allclose(a.double(), b.double(), rtol=1e-6, atol=0)
    assert st["cuda"].degree_bounds() == st["cpu"].degree_bounds()
    z = fix["z_test"]
    np.testing.assert_allclose(np.sort(envs["cuda"].evaluate_bler(z, 8)),
                               np.sort(envs["cpu"].evaluate_bler(z, 8)),
                               rtol=1e-6, atol=1e-12)
