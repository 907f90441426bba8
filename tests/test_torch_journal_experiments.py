"""The costlier journal experiments of the port (the oracle-driven and
online sweeps) run with ``--smoke --device cpu`` and write the same metric
files, with the same row lengths, as the JAX scripts run with the same
arguments (the others are in test_torch_journal_slice.py)."""

import pytest

from torch_jax_parity import check_experiment_metrics
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

# Each script at a small cell (K=27) with its JAX test's arguments.
EXPERIMENTS = [("sim_mmw_oracle_time", []), ("sim_all_mmw", []),
               ("sim_convergence", ["--repeat", "1"]),
               ("sim_bound_ablation", ["--repeat", "2", "--alg", "mmw"]),
               ("sim_online_methods", ["--repeat", "1"])]


@pytest.mark.parametrize("script,extra", EXPERIMENTS,
                         ids=[e[0] for e in EXPERIMENTS])
def test_experiment_writes_the_jax_metrics(script, extra, tmp_path):
    check_experiment_metrics(script, extra, tmp_path)
