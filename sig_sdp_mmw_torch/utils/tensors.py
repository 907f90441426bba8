"""Frozen dataclasses of tensors (the port's stand-in for registered
pytrees) and small tensor helpers."""

from __future__ import annotations

import dataclasses
from typing import Set

import numpy as np
import torch


class TensorFields:
    """Mixin for frozen dataclasses whose fields are tensors, nested
    containers of the same kind, or plain (static) values."""

    def to(self, device) -> "TensorFields":
        """A copy with every tensor field moved to ``device``."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorFields)):
                kw[f.name] = v.to(device)
        return dataclasses.replace(self, **kw)

    def tensor_devices(self) -> Set[str]:
        """Device types (``"cpu"``, ``"cuda"``) of every tensor field,
        nested containers included."""
        out: Set[str] = set()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out.add(v.device.type)
            elif isinstance(v, TensorFields):
                out |= v.tensor_devices()
        return out


def as_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor (a copy), bfloat16 (ml_dtypes) arrays
    included, bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def resolve_device(device) -> torch.device:
    """The device an entry point was asked to run on, with TF32 off (the
    reference multiplies in full float32).  A CUDA device that is not there
    raises: an entry point never moves to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available (pass device='cpu' to run on the "
                           "CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def cuda_sync(x=None) -> None:
    """Wait for queued device work when ``x`` is (or holds) a CUDA tensor,
    so a host timer around it measures the work and not its enqueue."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, TensorFields):
        if "cuda" in x.tensor_devices():
            torch.cuda.synchronize()


def index_sum_in_order(n: int, index: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """``zeros(n, ...).index_add_(0, index, src)`` with every element's
    sources added one at a time in ascending position, the order of a
    sequential scatter-add: the sources are grouped by their rank among
    those of the same target, and each group is one ``index_add_`` whose
    targets are distinct.  So no element takes two adds at once and the sum
    repeats bit for bit on the card, where ``index_add_`` into repeated
    indices adds with atomics in varying order; on the CPU it equals the
    sequential ``index_add_`` bit for bit."""
    out = torch.zeros((n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if index.numel() == 0:
        return out
    order = torch.argsort(index.long(), stable=True)
    tgt = index.long()[order]
    count = torch.bincount(tgt, minlength=n)
    rank = (torch.arange(tgt.numel(), device=tgt.device)
            - (torch.cumsum(count, 0) - count)[tgt])
    by_rank = torch.argsort(rank, stable=True)
    pos = 0
    for size in torch.bincount(rank).tolist():
        group = by_rank[pos:pos + size]
        pos += size
        out.index_add_(0, tgt[group], src[order[group]])
    return out
