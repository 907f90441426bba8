"""The ported slice end to end on the CPU: experiments/e2e_large.main at
cell=10 (K=300) against the JAX package's MMWEll search on the same state,
the port's independence from JAX, and its coverage of the JAX package's
modules and names."""

import ast
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import pytest

from sig_sdp_mmw_torch.experiments.e2e_large import main as e2e_main
from sig_sdp_mmw_torch.models.mmw import mmw_default_lanczos_m
from sig_sdp_mmw_torch.ops import bcsr as tb
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NIT = 20


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's pipeline, counting calls of the flat SpMM's plain version
    (the path a CPU tensor takes)."""
    calls = []
    ref = tb.bsr_spmm_flat_reference
    mp = pytest.MonkeyPatch()
    mp.setattr(tb, "bsr_spmm_flat_reference",
               lambda mat, V: calls.append(V.shape) or ref(mat, V))
    out = str(tmp_path_factory.mktemp("e2e") / "run.json")
    try:
        rec = e2e_main(cell=10, nit=NIT, flat_group=4, device="cpu",
                       out_path=out)
    finally:
        mp.undo()
    return rec, calls, out


def test_slice_is_feasible_and_went_through_flat_spmm(port_run):
    rec, calls, _ = port_run
    assert rec["K"] == 300 and rec["remainder"] == 0
    assert rec["verified_feasible"]
    assert rec["n_interf_vio"] == 0 and rec["n_asso_vio"] == 0
    assert rec["operand_devices"] == ["cpu"]
    # per iteration: 2 flat SpMMs per Lanczos step (S̃, S̃ᵀ) + 1 for xH
    m = mmw_default_lanczos_m(0.05, NIT)
    assert len(calls) == rec["n_probes"] * NIT * (2 * m + 1)
    # padded rows; D_pad pinned by the first probe (Z=36 -> 2Z=72 -> 128)
    assert set(calls) == {(384, 128)}


def test_slice_record_has_the_jax_tool_keys(port_run):
    """Every key of the JAX tool's record, the heuristic rows included
    (each with the JAX row's keys, its verdict consistent with its rem),
    and the device rounding on the batched route at this Kp."""
    rec, _, out = port_run
    with open(os.path.join(REPO, "E2E_LARGE.json")) as f:
        jax_rec = json.load(f)
    assert set(jax_rec) <= set(rec)
    assert (set(jax_rec["tail_decomposition"]) - {"note"}
            <= set(rec["tail_decomposition"]))
    for name in ("mgain", "mrand"):
        assert set(jax_rec[name]) <= set(rec[name])
        assert rec[name]["rem"] > 0 or rec[name]["verified_feasible"]
    assert rec["rounding"] == "device" and rec["search_mode"] == "binary"
    assert [r["route"] for r in rec["rounding_info"]] == \
        ["batch"] * rec["n_probes"]
    with open(out) as f:
        assert json.load(f)["Z_fin"] == rec["Z_fin"]
    assert os.path.exists(out.replace(".json", "_assignment.npz"))


def test_slice_z_matches_jax_search(port_run):
    """Z_fin within 1 of the JAX MMWEll search on the same state (the
    rounding draws differ, hence the slack)."""
    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.models.mmw_ell import MMWEll
    from sig_sdp_mmw_tpu.models.search import BinarySearchRelaxation

    env = LargeEnv(10, 75e-4, seed=0)
    S, Q, _ = env.generate_state_csr()
    ell = env.generate_ell()
    alg = MMWEll(nit=NIT, eta=0.05, use_bcsr=True, nattempt=10, seed=0)
    alg.prepare(ell, S, Q, block=128, dtype=jnp.bfloat16,
                store_transpose=True)
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = alg
    _, Z_jax, rem_jax = bs.run(ell)
    rec = port_run[0]
    assert rem_jax == 0
    assert (rec["lb"], rec["ub"]) == bs.set_bounds(ell)
    assert abs(rec["Z_fin"] - int(Z_jax)) <= 1


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = ("import sys, sig_sdp_mmw_torch, sig_sdp_mmw_torch.models.mmw_ell,"
            " sig_sdp_mmw_torch.experiments.e2e_large,"
            " sig_sdp_mmw_torch.experiments.million_link_e2e,"
            " sig_sdp_mmw_torch.experiments.bench_flat_spmm,"
            " sig_sdp_mmw_torch.ops.kernels,"
            " sig_sdp_mmw_torch.experiments.sim_mmw_time,"
            " sig_sdp_mmw_torch.experiments.profile_iteration,"
            " sig_sdp_mmw_torch.env.mob, sig_sdp_mmw_torch.models.rounding,"
            " sig_sdp_mmw_torch.models.rounding_ell,"
            " sig_sdp_mmw_torch.models.heuristics_ell,"
            " sig_sdp_mmw_torch.parallel.batch, sig_sdp_mmw_torch.models,"
            " sig_sdp_mmw_torch.ops.simplex,"
            " sig_sdp_mmw_torch.utils.checkpoint,"
            " sig_sdp_mmw_torch.experiments.pd_mmw_template,"
            " sig_sdp_mmw_torch.experiments.sim_all_bler,"
            " sig_sdp_mmw_torch.experiments.sim_all_mmw,"
            " sig_sdp_mmw_torch.experiments.sim_bound_ablation,"
            " sig_sdp_mmw_torch.experiments.sim_convergence,"
            " sig_sdp_mmw_torch.experiments.sim_graph_test,"
            " sig_sdp_mmw_torch.experiments.sim_mmw_oracle_time,"
            " sig_sdp_mmw_torch.experiments.sim_mmw_oracle_z,"
            " sig_sdp_mmw_torch.experiments.sim_online_iterations,"
            " sig_sdp_mmw_torch.experiments.sim_online_methods,"
            " sig_sdp_mmw_torch.parallel.mesh,"
            " sig_sdp_mmw_torch.parallel.distributed,"
            " sig_sdp_mmw_torch.utils.profiling, sig_sdp_mmw_torch.entry,"
            " sig_sdp_mmw_torch.experiments.sharded_large,"
            " sig_sdp_mmw_torch.experiments.plot_results,"
            " sig_sdp_mmw_torch.experiments.oracle_z_report,"
            " sig_sdp_mmw_torch.experiments.gap_c15_sweep,"
            " sig_sdp_mmw_torch.experiments.oracle_z_diagnose,"
            " sig_sdp_mmw_torch.experiments.conv_probe,"
            " sig_sdp_mmw_torch.experiments.bler_tail_fix,"
            " sig_sdp_mmw_torch.experiments.bler_tail_sweep,"
            " sig_sdp_mmw_torch.experiments.plateau_study,"
            " sig_sdp_mmw_torch.experiments.million_z19_probe,"
            " sig_sdp_mmw_torch.experiments.reorder_bench,"
            " sig_sdp_mmw_torch.experiments.profile_bcsr_build,"
            " sig_sdp_mmw_torch.experiments.million_link,"
            " sig_sdp_mmw_torch.experiments.perf_sweep,"
            " port_studies.oracle_z_pair, port_studies.oracle_z_devices,"
            " port_studies.oracle_z_eigh,"
            " sig_sdp_mmw_torch.utils.stats, sig_sdp_mmw_torch.utils.logging,"
            " sig_sdp_mmw_torch.native.builder, sig_sdp_mmw_torch.env.env,"
            " sig_sdp_mmw_torch.env.phy; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_port_sources_name_no_jax():
    """Neither the package, the port's one-off studies (``port_studies/``)
    nor chip_smoke.py imports jax or the JAX package, on any path (lazy
    imports included)."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|sig_sdp_mmw_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("sig_sdp_mmw_torch", "port_studies"):
        for root, _, names in os.walk(os.path.join(REPO, top)):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                assert not bad.match(line), f"{path}:{n}: {line.strip()}"


def test_slice_speculative_search_on_generic_blocks(port_run):
    """search="speculative" on 16x16 blocks (the kernels' short-block tile
    on the card): rem 0, verified, within 1 of the binary search's Z, with the
    waves and their candidates recorded."""
    rec = e2e_main(cell=10, nit=NIT, block=16, flat_group=4, device="cpu",
                   search="speculative", wave=4)
    assert rec["remainder"] == 0 and rec["verified_feasible"]
    assert rec["search_mode"] == "speculative(wave=4)"
    assert abs(rec["Z_fin"] - port_run[0]["Z_fin"]) <= 1
    assert rec["n_waves"] == len(rec["wave_rows"]) >= 1
    assert rec["n_probes"] == len(rec["probe_Z"]) == sum(
        r["candidates"] for r in rec["wave_rows"])


JAX_PKG = os.path.join(REPO, "sig_sdp_mmw_tpu")
PORT_PKG = os.path.join(REPO, "sig_sdp_mmw_torch")
# The three functions that reach pl.pallas_call, and the CUDA kernel
# wrappers that take their place in the port.
PALLAS_PORTS = {"bcsr_spmm_pallas": "bcsr_spmm",
                "bsr_spmm_pallas_flat": "bsr_spmm_flat",
                "bsr_spmm_pallas_vres": "bsr_spmm_vres"}
JAX_MODULES = sorted(
    os.path.relpath(os.path.join(root, n), JAX_PKG)
    for root, _, names in os.walk(JAX_PKG) for n in names
    if n.endswith(".py"))


def _public_names(path: str, pkg: str) -> set:
    """Public top-level names of a module: functions, classes and assigned
    names, and in a package's ``__init__.py`` the names it re-exports from
    its own package."""
    tree = ast.parse(open(path).read())
    init = os.path.basename(path) == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif (init and isinstance(node, ast.ImportFrom) and node.module
              and node.module.startswith(pkg)):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def test_port_covers_every_jax_module():
    assert len(JAX_MODULES) > 40
    missing = [m for m in JAX_MODULES
               if not os.path.exists(os.path.join(PORT_PKG, m))]
    assert not missing, missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_every_public_name(module):
    """Every public top-level name of a JAX module has a counterpart of the
    same name in the same module of the port; the Pallas functions have
    their CUDA wrappers instead."""
    want = _public_names(os.path.join(JAX_PKG, module), "sig_sdp_mmw_tpu")
    have = _public_names(os.path.join(PORT_PKG, module), "sig_sdp_mmw_torch")
    missing = {PALLAS_PORTS.get(n, n) for n in want} - have
    assert not missing, sorted(missing)
    if module == os.path.join("ops", "bcsr.py"):
        assert set(PALLAS_PORTS) <= want
