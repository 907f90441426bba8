"""Process-group initialization, the global mesh, and a small launcher
(port of :mod:`sig_sdp_mmw_tpu.parallel.distributed`).

The JAX package joins hosts with ``jax.distributed`` and lets XLA pick the
collectives.  Here every rank is a process of a ``torch.distributed``
group, started by ``torchrun`` (or :func:`launch`), and the backend is
named by the caller:

* ``"nccl"`` when every rank has a card of its own
  (``torchrun --nproc-per-node=N`` on an N-card host);
* ``"gloo"`` on the CPU, and when ranks share one card (NCCL refuses two
  ranks on one device; gloo takes CUDA tensors and moves them through the
  host).

Rank r's device is ``cuda:LOCAL_RANK % device_count`` (:func:`local_device`).
:func:`make_global_mesh` then lays every rank out as a (batch, graph) mesh
(:mod:`sig_sdp_mmw_torch.parallel.mesh`).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional, Sequence, Tuple

BACKENDS = ("nccl", "gloo")
COLLECTIVE_TIMEOUT_S = 600.0   # the longest any collective waits for a peer


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def local_device(device_type: str = "cuda"):
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` (the CPU for
    ``device_type="cpu"``)."""
    import torch

    if device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible to this rank")
    return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % n)


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join this process to the group, from torchrun's variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) unless given.  Does nothing in a single process (no
    ``init_method``, no ``MASTER_ADDR`` and a world of at most one rank).

    ``backend``: ``"nccl"`` (a card per rank on this host, else it raises)
    or ``"gloo"``.  With NCCL the rank's current device becomes
    :func:`local_device`.  Every collective's wait is bounded by
    ``COLLECTIVE_TIMEOUT_S``.
    """
    import torch
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return  # single process
    if backend == "nccl":
        here = _env_int("LOCAL_WORLD_SIZE") or world_size or 1
        cards = torch.cuda.device_count()
        if here > cards:
            raise ValueError(
                f"backend 'nccl' needs a card per rank: {here} ranks on this "
                f"host, {cards} cards visible (NCCL refuses two ranks on one "
                "device); use backend 'gloo' for ranks that share a card")
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))


def make_global_mesh(batch_size: Optional[int] = None,
                     axis_names: Tuple[str, str] = ("batch", "graph")):
    """(batch, graph) mesh over every rank of the group."""
    import torch.distributed as dist

    from sig_sdp_mmw_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_devices=n, axis_names=axis_names,
                     batch_size=batch_size)


def _free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, nprocs: int, args: Sequence = (), *,
           backend: str = "gloo", device: str = "cpu",
           timeout_s: float = 600.0) -> list:
    """Run ``target`` (``"module:function"``) in ``nprocs`` fresh processes
    joined as one group, as ``torchrun`` would on this host, and return
    each rank's return value, in rank order.

    Every rank gets torchrun's variables (a free localhost port), calls
    :func:`init_distributed` with ``backend``, sets its device (for
    ``device="cuda"``: :func:`local_device`) and takes this process's
    torch threads or its share of the cores, whichever is fewer, then
    calls ``function(*args)``.  Arguments and results are
    pickled through a private temporary directory.  A rank that fails
    stops the others; so does ``timeout_s``, counted from the start.
    Raises RuntimeError with the end of every failed rank's output (a rank
    that fails first often takes its peers down with it), or TimeoutError
    with rank 0's."""
    import torch

    work = tempfile.mkdtemp(prefix="sig_launch_")
    procs = []
    try:
        with open(os.path.join(work, "call.pkl"), "wb") as f:
            threads = min(torch.get_num_threads(),
                          max(1, (os.cpu_count() or 1) // nprocs))
            pickle.dump((target, tuple(args), backend, device, threads), f)
        port = _free_port()
        path = os.pathsep.join(p for p in sys.path if p)
        logs = [os.path.join(work, f"rank{r}.log") for r in range(nprocs)]
        for r in range(nprocs):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                       RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(nprocs), PYTHONPATH=path)
            with open(logs[r], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _WORKER, work], env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch {target} x{nprocs}: timed out "
                                   f"after {timeout_s:.0f} s:\n"
                                   f"{_tail(logs[0])}")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs)
               if p.returncode not in (None, 0)]
        if bad:
            raise RuntimeError(f"launch {target} x{nprocs}: " + "\n".join(
                f"rank {r} exited with {procs[r].returncode}:\n"
                f"{_tail(logs[r])}" for r in bad))
        out = []
        for r in range(nprocs):
            with open(os.path.join(work, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _tail(path: str, nbytes: int = 4000) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(f.tell() - nbytes, 0))
        return f.read().decode(errors="replace")


def _worker(work: str) -> int:
    """One rank of :func:`launch`."""
    import torch
    import torch.distributed as dist

    with open(os.path.join(work, "call.pkl"), "rb") as f:
        target, args, backend, device, threads = pickle.load(f)
    rank = int(os.environ["RANK"])
    try:
        torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(local_device())
        init_distributed(backend)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        tmp = os.path.join(work, f".result{rank}.pkl")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(work, f"result{rank}.pkl"))
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    return 0


_WORKER = ("import sys; from sig_sdp_mmw_torch.parallel.distributed import "
           "_worker; sys.exit(_worker(sys.argv[1]))")
