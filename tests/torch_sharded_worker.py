"""Rank bodies of the port's multi-process parity tests
(tests/test_torch_sharded.py, tests/test_torch_entry.py), run by
``sig_sdp_mmw_torch.parallel.distributed.launch`` in fresh processes that
import torch and the port, never jax: the draws each solve takes are
recorded in the test process (``RecordingDraws``, around the JAX package's
draws) and replayed here (``ReplayDraws``)."""

import numpy as np
import torch


class RecordingDraws:
    """Passes every draw through from ``base`` and records it by (role,
    arguments); a draw that returns a draws object (``scenario_solve``) is
    recorded as a recorder of its own."""

    def __init__(self, base):
        self._base = base
        self.calls = {}

    def __getattr__(self, role):
        fn = getattr(self._base, role)

        def call(*args):
            out = fn(*args)
            if not isinstance(out, torch.Tensor):
                out = RecordingDraws(out)
            self.calls[(role, args)] = out
            return out

        return call

    def record(self) -> dict:
        """The draws as plain data (tensors, nested dicts)."""
        return {k: v.record() if isinstance(v, RecordingDraws) else v
                for k, v in self.calls.items()}


class ReplayDraws:
    """The draws of a :meth:`RecordingDraws.record`, by (role, arguments)."""

    def __init__(self, record: dict):
        self._record = record

    def __getattr__(self, role):
        def call(*args):
            out = self._record[(role, args)]
            return ReplayDraws(out) if isinstance(out, dict) else out.clone()

        return call


def _np(x):
    return x.detach().cpu().numpy()


def sharded_solves(cases: dict) -> dict:
    """Every case of ``cases`` on this rank: name -> (kind, kwargs).

    kind "dense": ``mmw_solve(state, graph=...)``; "ell": ``mmw_solve_ell``
    on the replicated EllState; "bcsr": ``mmw_solve_ell`` on ``ell`` with
    this rank's ``shard_rows`` of ``bcsr``; "batched":
    ``solve_scenarios_batched(mesh=...)``.  ``batch_size`` picks the mesh
    (over every rank) whose graph axis the solve runs on.  Returns per case
    the outputs as numpy arrays and the bytes the graph axis gathered."""
    from sig_sdp_mmw_torch.models.mmw import mmw_solve
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.ops.bcsr import shard_rows
    from sig_sdp_mmw_torch.parallel import make_mesh, solve_scenarios_batched

    meshes = {}
    out = {}
    for name, (kind, kw) in cases.items():
        kw = dict(kw)
        b = kw.pop("batch_size")
        if b not in meshes:
            meshes[b] = make_mesh(batch_size=b)
        mesh = meshes[b]
        graph = mesh.axis("graph")
        draws = ReplayDraws(kw.pop("draws"))
        if kind == "dense":
            o = mmw_solve(kw.pop("state"), kw.pop("Z"), draws=draws,
                          graph=graph, **kw)
        elif kind == "ell":
            o = mmw_solve_ell(kw.pop("ell"), kw.pop("Z"), draws=draws,
                              graph=graph, **kw)
        elif kind == "bcsr":
            ops = shard_rows(kw.pop("bcsr"), graph.index, graph.size)
            o = mmw_solve_ell(kw.pop("ell"), kw.pop("Z"), draws=draws,
                              bcsr=ops, graph=graph, **kw)
        else:
            graph = mesh.axis("batch")
            o = solve_scenarios_batched(kw.pop("states"), kw.pop("Z"),
                                        draws=draws, mesh=mesh, **kw)
        out[name] = dict(X_half=_np(o.X_half), ub_final=_np(o.ub_final),
                         shape=dict(mesh.shape),
                         gathered_bytes=graph.gathered_bytes)
    return out


def _axis_checks(ax) -> dict:
    """gather_rows of this rank's part of 10 rows (row i = [3i, 3i+1,
    3i+2]), sum_over of a part that names the rank, max_over of its index."""
    x = torch.arange(30.0, dtype=torch.float64).reshape(10, 3)
    r0, r1 = ax.rows(10)
    out = dict(gathered=_np(ax.gather_rows(x[r0:r1], 10)),
               sum=_np(ax.sum_over(torch.full((4,), 1.0 / (ax.index + 3),
                                              dtype=torch.float64))),
               max=float(ax.max_over(torch.tensor(float(ax.index),
                                                  dtype=torch.float64))))
    out["bytes"] = ax.gathered_bytes
    out["expected_bytes"] = 8 * ax.size * (-(-10 // ax.size) * 3 + 4 + 1)
    return out


def mesh_collectives() -> dict:
    """A batch 2 x graph 2 mesh and a batch 1 x graph 4 mesh over the 4
    ranks: layout and the axis collectives."""
    from sig_sdp_mmw_torch.parallel import make_global_mesh, make_mesh

    mesh = make_global_mesh()
    mesh4 = make_mesh(4, batch_size=1)
    return dict(shape=dict(mesh.shape), coords=dict(mesh.coords),
                coords4=dict(mesh4.coords),
                graph=_axis_checks(mesh.axis("graph")),
                batch=_axis_checks(mesh.axis("batch")),
                graph4=_axis_checks(mesh4.axis("graph")))


def fail_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 says no")
    dist.barrier()
