"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

Each kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels``
at first use and bound with ctypes through a plain C launch function that
returns the launch's ``cudaError_t``.  Nothing here runs at import time: the
CPU tests import every module on a machine without ``nvcc``.  Builds of
different kernels may run at once (one lock per kernel), so a caller can
start every ``nvcc`` together.

* ``bsr_spmm_flat``  — flat block-CSR SpMM (``bsr_spmm_flat.cu``);
* ``bcsr_spmm_ell``  — block-ELL SpMM (``bcsr_spmm_ell.cu``);
* ``bsr_spmm_vres``  — flat block-CSR SpMM with V resident in L2
  (``bsr_spmm_vres.cu``).

The first two share their tile code through ``spmm_tile.cuh``; a library's
build hash covers the headers of ``csrc/`` as well as its own source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Dict

from sig_sdp_mmw_torch.utils.build import build_shared_library

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# Compiler output of each build made by this process (ptxas register and
# shared-memory report), by kernel name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _headers_digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``; argtypes are set by the
    caller's binding."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            path, log = build_shared_library(os.path.join(CSRC, f"{name}.cu"),
                                             "kernels", [_nvcc(), *NVCC_FLAGS],
                                             key=_headers_digest())
            build_logs[name] = log
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def bsr_spmm_flat_library() -> ctypes.CDLL:
    lib = load_kernel_library("bsr_spmm_flat")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bsr_spmm_flat_launch.restype = i32
    lib.bsr_spmm_flat_launch.argtypes = [vp, vp, vp, i32, vp, vp, i32, i32,
                                         i32, vp]
    return lib


def bcsr_spmm_ell_library() -> ctypes.CDLL:
    lib = load_kernel_library("bcsr_spmm_ell")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bcsr_spmm_ell_launch.restype = i32
    lib.bcsr_spmm_ell_launch.argtypes = [vp, vp, i32, i32, vp, vp, i64, i32,
                                         i32, vp]
    return lib


def bsr_spmm_vres_library() -> ctypes.CDLL:
    lib = load_kernel_library("bsr_spmm_vres")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bsr_spmm_vres_launch.restype = i32
    lib.bsr_spmm_vres_launch.argtypes = [vp, vp, vp, i32, vp, i64, vp, i32,
                                         i32, i32, vp]
    return lib


# Every kernel's binding, by name (chip_smoke.py builds them all at once).
LIBRARIES = {"bsr_spmm_flat": bsr_spmm_flat_library,
             "bcsr_spmm_ell": bcsr_spmm_ell_library,
             "bsr_spmm_vres": bsr_spmm_vres_library}
