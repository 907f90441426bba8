"""Port parity on the matched-Z oracle study's users
(``tests/fixtures/oracle_z_cell10_geometry.npz``, the JAX package's
``WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=s)`` users for
s = 0..99, written by ``tests/torch_jax_geometry.py``).

* The fixture holds the JAX draws (float32, as a process without x64 makes
  them) for seeds 0, 57 and 99, bit for bit.
* The port's state on those users equals the JAX package's (the JAX env
  given the users as ``test_torch_dense_env.py``'s injected geometry, and
  the state the study computes without x64): S and h_max to rtol 2e-5,
  ``test_torch_dense_env.py``'s tolerance of the port's state against the
  reference (its 1e-6 against JAX misses here: the JAX geometry is float32
  arithmetic, the port's float64, and 2% of seed 0's entries part by up to
  3.5e-6); Q and the degree bounds exactly.
* The oracle search (``BinarySearchRelaxation`` + ``ADMMSDPSolver(nit=100)``,
  the port on the JAX package's rounding draws) on seed 0's users in
  float64 probes JAX's Z path, each probe feasible or not alike, to JAX's
  Z_fin (the JAX search run live by ``torch_jax_oracle_split.py
  --jax-probes 0`` in a child process with XLA on one thread, beside the
  port's; both states built in float64 from the same users).
  Float32 is not held to that: there the two packages' ADMM iterates part
  at the float32 noise (max|ΔX_final| 2.8e-5 to 4.7e-5 at nit 500, the
  states ~2e-6 apart), and at a probe on the feasibility boundary that
  moves the greedy rounding (seed 7 at Z=11: the port rounds, JAX leaves
  2), each package's rounding agreeing on the same factor.  A failed
  probe's remainder count is not held even in float64: it moves with the
  last bits (XLA's thread count; on seed 1 factors 9e-15 apart round Z=9
  to 3 and 4).
* The two roundings agree on the same factor: at seed 0's boundary probe
  (Z=13, float32, nit 100) each package's rounding of the port's factor,
  with the same draws, leaves the same remainder.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sig_sdp_mmw_torch.core.problem import from_jax_arrays
from sig_sdp_mmw_torch.env import WirelessEnv as TEnv
from sig_sdp_mmw_torch.models import BinarySearchRelaxation, verify_assignment
from sig_sdp_mmw_torch.models import admm as ta
from sig_sdp_mmw_torch.models import base as tbase
from sig_sdp_mmw_torch.models.rounding import rounding as t_round
from sig_sdp_mmw_tpu.env import WirelessEnv as JEnv
from sig_sdp_mmw_tpu.models.rounding import rounding as j_round
from torch_jax_geometry import CELL, FIXTURE, RHO, jax_geometry
from torch_jax_parity import JaxDraws, jax_fields, script
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def geo():
    return dict(np.load(FIXTURE))


def port_env(geo, seed, dtype=torch.float32):
    return TEnv(cell_size=CELL, sta_density_per_1m2=RHO, seed=seed,
                device="cpu", dtype=dtype, sta_locs=geo["sta_locs"][seed],
                sta_dirs=geo["sta_dirs"][seed])


def jax_state32(seed):
    with jax.enable_x64(False):
        return JEnv(cell_size=CELL, sta_density_per_1m2=RHO,
                    seed=seed).generate_S_Q_hmax()


@pytest.mark.parametrize("seed", [0, 57, 99])
def test_fixture_holds_the_jax_users(geo, seed):
    assert geo["sta_locs"].shape == geo["sta_dirs"].shape == (100, 300, 2)
    assert geo["sta_locs"].dtype == geo["sta_dirs"].dtype == np.float32
    assert (int(geo["cell"]), float(geo["rho"])) == (CELL, RHO)
    locs, dirs = jax_geometry(seed)
    np.testing.assert_array_equal(geo["sta_locs"][seed], locs)
    np.testing.assert_array_equal(geo["sta_dirs"][seed], dirs)


def test_injected_users_must_fit_the_scenario(geo):
    """A fixture row placed in a scenario of another size is refused (the
    study's --geometry at another cell)."""
    for kw in (dict(sta_locs=geo["sta_locs"][0]),
               dict(sta_dirs=geo["sta_dirs"][0])):
        with pytest.raises(ValueError, match="places"):
            TEnv(cell_size=5, sta_density_per_1m2=RHO, seed=0, device="cpu",
                 **kw)


@pytest.mark.parametrize("seed", [0, 57, 99])
def test_port_state_on_the_jax_users_matches_jax(geo, seed):
    ts = port_env(geo, seed).generate_S_Q_hmax()
    assert ts.S.dtype == torch.float32
    # The JAX env given the users as test_torch_dense_env.py's injected
    # geometry gives them (this process's config), and the state the study
    # computes (without x64).  Both compute the geometry in float32, the
    # port in float64: on seed 0, 2% of S's entries part by more than 1e-6
    # (at most 3.5e-6), so both are held to the rtol 2e-5 that
    # test_torch_dense_env.py holds the port's state to the reference with.
    je = JEnv(cell_size=CELL, sta_density_per_1m2=RHO, seed=seed)
    je.sta_locs = jnp.asarray(geo["sta_locs"][seed])
    for js in (je.generate_S_Q_hmax(), jax_state32(seed)):
        rtol = 2e-5
        assert (ts.K, ts.Kp) == (js.K, js.Kp) == (300, 304)
        np.testing.assert_allclose(ts.S.numpy(), np.asarray(js.S),
                                   rtol=rtol)
        np.testing.assert_array_equal(ts.Q.numpy(), np.asarray(js.Q))
        np.testing.assert_allclose(ts.h_max.numpy(), np.asarray(js.h_max),
                                   rtol=rtol)
        assert ts.degree_bounds() == js.degree_bounds()


def jax_search_process(seed):
    """The JAX search's float64 probes on ``seed``'s users, started in a
    child process (``torch_jax_oracle_split.py --jax-probes``) with XLA and
    the LAPACK its eigh calls on one thread: threaded, its loop of small
    [304, 304] ops spins beside the suite's other workers and takes minutes
    where one thread takes ~20 s."""
    root = os.path.dirname(TESTS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))),
        OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
        XLA_FLAGS=" ".join(filter(None, (
            os.environ.get("XLA_FLAGS"), "--xla_cpu_multi_thread_eigen=false",
            "intra_op_parallelism_threads=1"))))
    return subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_jax_oracle_split.py"),
         "--jax-probes", str(seed)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_oracle_search_matches_jax_on_the_jax_users(geo, monkeypatch):
    jax_run = jax_search_process(0)
    try:
        ts = port_env(geo, 0, torch.float64).generate_S_Q_hmax()
        monkeypatch.setattr(tbase, "TorchDraws", lambda s, device, stream: (
            JaxDraws(jax.random.fold_in(jax.random.PRNGKey(s), stream))))
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = ta.ADMMSDPSolver(nit=100)
        zt, Zt, remt = bs.run(ts)
        out, err = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, err[-2000:]
    probes_j, Zj = json.loads(out.strip().splitlines()[-1])
    probes = bs.LOGGED_NP_DATA["bs_search_per_it"][:, 3:8].astype(int)
    # lo, hi, mid, Z and whether the probe rounded feasibly: the search's
    # path.  A failed probe's remainder count is not held: at the boundary
    # it moves with the last bits (XLA's thread count moves it in JAX).
    assert ([(*p[:4], p[4] == 0) for p in probes.tolist()]
            == [(*p[:4], p[4] == 0) for p in probes_j])
    assert (Zt, remt) == (Zj, 0)
    assert verify_assignment(ts, zt)[0]


def test_roundings_agree_on_the_port_factor_at_the_boundary(geo):
    """Seed 0's boundary probe (Z=13, float32, nit 100, the search's sixth
    call): the JAX package's rounding and the port's, on the port's ADMM
    factor and the same draws, leave the same remainder."""
    seed, Z, nit, call = 0, 13, 100, 6
    js = jax_state32(seed)
    ts = port_env(geo, seed).generate_S_Q_hmax()
    _, ub = ts.degree_bounds()
    rank_pad = min(((max(Z, ub) * 2 + 15) // 16) * 16, ts.Kp - 1)
    H = ta.admm_sdp_solve(ts, float(Z), nit=nit, rank_pad=rank_pad)[0]
    key = jax.random.fold_in(jax.random.PRNGKey(1234), call)
    with jax.enable_x64(False):
        rem_j = j_round(Z, H.numpy(), js, key)[2]
    rem_t = t_round(Z, H, from_jax_arrays(jax_fields(js)),
                    JaxDraws(key, nattempt=10))[2]
    assert rem_t == rem_j


def test_diagnosis_verdict_follows_its_two_budgets(geo):
    """oracle_z_diagnose's verdict is the JAX tool's rule
    (tools/oracle_z_diagnose.py:72-77) on the two remainders it measures,
    here at tiny budgets on seed 0's users."""
    from sig_sdp_mmw_torch.experiments import oracle_z_diagnose as od

    rec = od.diagnose_seed(0, 11, geometry=geo, device="cpu", oracle_nit=5,
                           oracle_attempts=2, mmw_nit=5, mmw_attempts=2)
    want = ("mmw" if rec["rem_mmw_hi"] == 0 else
            "oracle" if rec["rem_oracle_hi"] != 0 else "gap")
    assert rec["verdict"] == od.VERDICTS[want]
    assert (rec["seed"], rec["Z"]) == (0, 11)


def test_device_comparison_of_one_device_with_itself(geo):
    """oracle_z_devices with both runs on the CPU and the CPU's draws: the
    same probes, no split, the same MMW factor (what the card's run is held
    against).  At cell 5 (K=75: the fixture's first 75 users of seed 0,
    scaled into its 100 m grid) to keep it short."""
    dv = script("port_studies", "oracle_z_devices")

    small = {"sta_locs": geo["sta_locs"][:, :75] * 0.5,
             "sta_dirs": geo["sta_dirs"][:, :75]}
    rec = dv.compare_seed(0, small, cell=5, oracle_nit=5, mmw_nit=5,
                          devices=(("cuda", "cpu"), ("cpu", "cpu")),
                          draw_device="cpu")
    assert rec["cuda_probes"] == rec["cpu_probes"]
    assert rec["first_split_probe"] is None and rec["cuda_Z"] == rec["cpu_Z"]
    assert rec["max_dX_half_raw"] == 0.0
    assert rec["cuda_mmw_rem"] == rec["cpu_mmw_rem"]
