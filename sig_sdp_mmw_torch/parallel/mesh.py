"""The (batch, graph) mesh over ``torch.distributed`` ranks (port of
:mod:`sig_sdp_mmw_tpu.parallel.mesh`).

The JAX package lays its devices out as a 2-D mesh and lets GSPMD insert
the collectives.  Here a mesh is the world's ranks laid out the same way
(rank r at row ``r // graph``, column ``r % graph``), with one process
group per mesh row and one per mesh column:

* ``batch`` — independent scenario instances, split over the mesh rows
  (the reference's seed loops);
* ``graph`` — the user axis K of one instance, its rows split over the
  ranks of a mesh row.  The solvers take this axis as a :class:`MeshAxis`
  and make each collective themselves: a product on the rank's own rows,
  then an all-gather (:meth:`MeshAxis.gather_rows`).

In a single process every axis has length 1 and every collective is the
identity, so the same code runs unsharded.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import torch

from sig_sdp_mmw_torch.ops.bcsr import shard_range
from sig_sdp_mmw_torch.utils.profiling import span


def mesh_shape(n: int, batch_size: Optional[int] = None) -> Tuple[int, int]:
    """(batch, graph) of an n-device mesh, factored as the JAX
    ``make_mesh`` does: by default the largest batch <= sqrt(n) that
    divides n (so batch <= graph)."""
    if batch_size is None:
        batch_size = 1
        for b in range(math.isqrt(n), 0, -1):
            if n % b == 0:
                batch_size = b
                break
    if n % batch_size:
        raise ValueError(f"batch_size {batch_size} does not divide {n}")
    return batch_size, n // batch_size


@dataclasses.dataclass
class MeshAxis:
    """One mesh axis as this rank sees it: the process group along it
    (None in a single process), its length and this rank's index on it.

    ``gathered_bytes`` and ``gathers`` count what :meth:`gather_rows`,
    :meth:`sum_over` and :meth:`max_over` have received on this rank (each
    call's output bytes).  Gloo and NCCL groups both take CUDA tensors."""

    group: Optional[object] = None
    size: int = 1
    index: int = 0
    gathered_bytes: int = 0
    gathers: int = 0

    def rows(self, n: int) -> Tuple[int, int]:
        """[r0, r1): this rank's part of n rows (or block-rows)."""
        return shard_range(n, self.index, self.size)

    def _all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """[size * len(local), ...]: every rank's ``local`` (equal shapes)
        in rank order."""
        import torch.distributed as dist

        src = local.contiguous()
        out = torch.empty((self.size * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        with span("graph.all_gather"), warnings.catch_warnings():
            # Newer releases rename it all_gather_single; older ones lack
            # that name.
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, src, group=self.group)
        self.gathered_bytes += out.numel() * out.element_size()
        self.gathers += 1
        return out

    def gather_rows(self, local: torch.Tensor, n: int,
                    unit: int = 1) -> torch.Tensor:
        """The [n * unit, ...] tensor whose rows [r0 * unit, r1 * unit)
        (``rows(n)``) this rank holds as ``local``: every rank's part,
        gathered.  A part shorter than ``ceil(n / size)`` units (the last)
        is padded with zero rows for the collective and the padding cut.
        Bit for bit the same on every rank of the axis."""
        if self.size == 1:
            return local
        chunk = -(-n // self.size) * unit
        pad = chunk - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad,
                                                       *local.shape[1:]))])
        return self._all_gather(local)[:n * unit]

    def sum_over(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``partial`` (equal shapes), added in
        rank order on each rank, so every rank gets the same bits (a
        gather, not an all-reduce, whose order the backend picks)."""
        if self.size == 1:
            return partial
        parts = self._all_gather(partial.unsqueeze(0))
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def max_over(self, x: torch.Tensor) -> torch.Tensor:
        """The largest of every rank's scalar ``x`` (exact in any order)."""
        if self.size == 1:
            return x
        return torch.max(self._all_gather(x.reshape(1)))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (batch, graph) mesh over the world's ranks, from this rank.

    ``shape[name]`` reads as the JAX mesh's; ``coords[name]`` is this
    rank's index on each axis and :meth:`axis` its :class:`MeshAxis`."""

    axis_names: Tuple[str, str]
    shape: Dict[str, int]
    coords: Dict[str, int]
    axes: Dict[str, MeshAxis]
    rank: int = 0

    def axis(self, name: str) -> MeshAxis:
        """A fresh handle on axis ``name`` (its own byte counters)."""
        return dataclasses.replace(self.axes[name], gathered_bytes=0,
                                   gathers=0)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("batch", "graph"),
              batch_size: Optional[int] = None) -> Mesh:
    """Build a 2-D (batch, graph) mesh over the ranks of the initialized
    process group (one rank in a single process).

    ``batch_size`` fixes the batch-axis length; by default the mesh is
    factored as :func:`mesh_shape` does.  A mesh spans every rank: every
    rank calls this together (it creates the process groups).
    """
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n < world:
        raise ValueError(f"requested {n} devices; a mesh spans all {world} "
                         "ranks")
    b, g = mesh_shape(n, batch_size)
    coords = {axis_names[0]: rank // g, axis_names[1]: rank % g}
    axes = {name: MeshAxis(size=size, index=coords[name])
            for name, size in zip(axis_names, (b, g))}
    if initialized:
        # Every rank creates every group, in one order.
        for row in range(b):
            grp = dist.new_group(list(range(row * g, row * g + g)))
            if row == coords[axis_names[0]] and g > 1:
                axes[axis_names[1]].group = grp
        for col in range(g):
            grp = dist.new_group(list(range(col, n, g)))
            if col == coords[axis_names[1]] and b > 1:
                axes[axis_names[0]].group = grp
    return Mesh(axis_names=tuple(axis_names),
                shape={axis_names[0]: b, axis_names[1]: g}, coords=coords,
                axes=axes, rank=rank)
