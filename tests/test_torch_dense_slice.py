"""The dense slice end to end on the CPU: the drive recipe (WirelessEnv ->
BinarySearchRelaxation + MMW -> verification -> BLER) on the K=300
reference geometry against the JAX package's search on the same state,
the sim_mmw_time entry point, and the online controller."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest

from sig_sdp_mmw_torch.env import Controller, MobileEnv, WirelessEnv
from sig_sdp_mmw_torch.experiments.sim_mmw_time import main as mmw_time_main
from sig_sdp_mmw_torch.models import MMW, BinarySearchRelaxation
from sig_sdp_mmw_torch.models import verify_assignment
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def test_recipe_matches_jax_search(env_mid):
    """rem 0, verified, Z_fin within 1 of the JAX search on the same state
    and settings (the draws differ), which is the record chip_smoke.py
    holds the card's run to."""
    from chip_smoke import DENSE_Z_REF
    from sig_sdp_mmw_tpu.env import WirelessEnv as JEnv
    from sig_sdp_mmw_tpu.models import MMW as JMMW
    from sig_sdp_mmw_tpu.models import BinarySearchRelaxation as JBS

    je = JEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=3, pad_to=320)
    je.sta_locs = jnp.asarray(env_mid["sta_locs"])
    jbs = JBS()
    jbs.feasibility_check_alg = JMMW(nit=100, eta=0.05, seed=0)
    _, Z_jax, rem_jax = jbs.run(je.generate_S_Q_hmax())
    assert rem_jax == 0 and Z_jax == DENSE_Z_REF

    e = WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=3,
                    pad_to=320, device="cpu", sta_locs=env_mid["sta_locs"])
    st = e.generate_S_Q_hmax()
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = MMW(nit=100, eta=0.05, seed=0)
    z, Z, rem = bs.run(st)
    assert rem == 0 and verify_assignment(st, z)[0]
    assert abs(Z - Z_jax) <= 1
    assert bs.set_bounds(st) == jbs.set_bounds(je.generate_S_Q_hmax())
    bler = e.evaluate_bler(z, Z)
    assert bler.shape == (300,) and np.all(np.isfinite(bler))
    assert bler.mean() < 0.01
    assert e.evaluate_bler(np.zeros(300, int), 1).mean() >= 0.99


def test_sim_mmw_time_smoke_writes_csvs(tmp_path):
    out = str(tmp_path / "mmw_time")
    path = mmw_time_main(["--smoke", "--device", "cpu", "--out", out])
    assert path == out
    for name in ("mmw150-time-5-75", "mmw150-fused-5-75"):
        with open(os.path.join(out, name)) as f:
            rows = list(csv.reader(f))
        assert len(rows) == 1
        vals = np.array(rows[0][2:], float)
        assert vals.size == (6 if "time" in name else 1)
        assert np.all(np.isfinite(vals)) and np.all(vals > 0)


class _FixedSchedule:
    """A solver stand-in: slot k % Z for user k, at once."""

    def __init__(self, Z):
        self.Z = Z

    def run(self, state):
        return np.arange(state.K) % self.Z, self.Z, 0


def test_controller_counts_every_period():
    env = MobileEnv(cell_size=5, sta_density_per_1m2=0.0075, seed=0,
                    device="cpu")
    periods = []
    pckl = env.evaluate_pckl
    env.evaluate_pckl = lambda z, Z: periods.append(Z) or pckl(z, Z)
    ctl = Controller()
    ctl.env, ctl.alg = env, _FixedSchedule(8)
    locs0 = env.sta_locs.clone()
    lost, sent, clock_us, latency = ctl.run(total_time_s=0.003,
                                            mob_spd_meter_s=1.0)
    assert len(periods) >= 3
    assert sent == env.n_sta * len(periods)
    assert 0 <= lost <= sent
    assert clock_us == pytest.approx(len(periods) * 8 * 125.0)
    assert clock_us > 3000.0 and len(latency) >= 1
    assert float((env.sta_locs - locs0).abs().max()) > 0
