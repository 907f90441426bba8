"""The port's mesh and process-group layer (sig_sdp_mmw_torch.parallel.mesh
and .distributed) against the JAX package's make_mesh, and its collectives
over gloo ranks on the CPU (each launch joined under a timeout).

Tolerances: none; factoring, errors and gathered values are exact."""

import numpy as np
import pytest
import torch

from sig_sdp_mmw_tpu.parallel import make_mesh as j_make_mesh
from sig_sdp_mmw_torch.parallel import (init_distributed, make_global_mesh,
                                        make_mesh)
from sig_sdp_mmw_torch.parallel.distributed import launch
from sig_sdp_mmw_torch.parallel.mesh import MeshAxis, mesh_shape
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)

LAUNCH_TIMEOUT_S = 240


def _jax_shape(n, batch_size=None):
    m = j_make_mesh(n, batch_size=batch_size)
    return m.shape["batch"], m.shape["graph"]


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert mesh_shape(n) == _jax_shape(n)
    for b in range(1, n + 1):
        if n % b == 0:
            assert mesh_shape(n, b) == _jax_shape(n, b)


def test_mesh_errors_match_jax():
    with pytest.raises(ValueError, match="batch_size 3 does not divide 8"):
        j_make_mesh(8, batch_size=3)
    with pytest.raises(ValueError, match="batch_size 3 does not divide 8"):
        mesh_shape(8, 3)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        j_make_mesh(9)
    # One process is a world of one rank.
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2)


def test_single_process_mesh_and_init(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    init_distributed("gloo")                 # nothing to join
    assert not torch.distributed.is_initialized()
    mesh = make_global_mesh()
    assert mesh.shape == {"batch": 1, "graph": 1}
    assert mesh.coords == {"batch": 0, "graph": 0}
    ax = mesh.axis("graph")
    x = torch.arange(6.0).reshape(3, 2)
    assert ax.gather_rows(x, 3) is x and ax.sum_over(x) is x
    assert ax.rows(10) == (0, 10) and ax.gathered_bytes == 0


def test_nccl_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="use backend 'gloo'"):
        init_distributed("nccl", init_method="tcp://127.0.0.1:1",
                         world_size=2, rank=0)
    with pytest.raises(ValueError, match="backend must be one of"):
        init_distributed("mpi", init_method="tcp://127.0.0.1:1",
                         world_size=2, rank=0)
    assert not torch.distributed.is_initialized()


def test_mesh_axis_row_parts():
    """rows(): ceil parts, the rest in the last; an empty part raises."""
    parts = [MeshAxis(size=4, index=g).rows(10) for g in range(4)]
    assert parts == [(0, 3), (3, 6), (6, 9), (9, 10)]
    with pytest.raises(ValueError, match="non-empty"):
        MeshAxis(size=4, index=3).rows(5)


@pytest.fixture(scope="module")
def collectives():
    return launch("torch_sharded_worker:mesh_collectives", 4,
                  backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)


def test_mesh_layout_over_ranks(collectives):
    """Rank r sits at (r // graph, r % graph) of a batch 2 x graph 2 mesh
    (and at (0, r) of batch 1 x graph 4), as the JAX mesh's reshape."""
    for r, rec in enumerate(collectives):
        assert rec["shape"] == {"batch": 2, "graph": 2}
        assert rec["coords"] == {"batch": r // 2, "graph": r % 2}
        assert rec["coords4"] == {"batch": 0, "graph": r}


@pytest.mark.parametrize("axis", ["graph", "batch", "graph4"])
def test_mesh_collectives_over_ranks(collectives, axis):
    """gather_rows of uneven parts (10 rows over the axis), sum_over in
    rank order and max_over: every rank of the axis gets the same bits,
    equal to the values computed on one process."""
    for r, rec in enumerate(collectives):
        got = rec[axis]
        size = {"graph": 2, "batch": 2, "graph4": 4}[axis]
        np.testing.assert_array_equal(got["gathered"],
                                      np.arange(30.0).reshape(10, 3))
        want = sum(np.full(4, 1.0 / (g + 3)) for g in range(size))
        np.testing.assert_array_equal(got["sum"], want)
        assert got["max"] == size - 1
        assert got["bytes"] == got["expected_bytes"]


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 says no"):
        launch("torch_sharded_worker:fail_on_rank_1", 2, backend="gloo",
               timeout_s=LAUNCH_TIMEOUT_S)
