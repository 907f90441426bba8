"""Frozen dataclasses of tensors: the port's stand-in for registered pytrees."""

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
