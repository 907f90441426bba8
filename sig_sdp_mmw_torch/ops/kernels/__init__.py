"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

Each kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels``
at first use and bound with ctypes through a plain C launch function that
returns the launch's ``cudaError_t``.  Nothing here runs at import time: the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

from sig_sdp_mmw_torch.utils.build import build_shared_library

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Compiler output of each build made by this process (ptxas register and
# shared-memory report), by kernel name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``; argtypes are set by the
    caller's binding."""
    with _lock:
        if name not in _libs:
            path, log = build_shared_library(os.path.join(CSRC, f"{name}.cu"),
                                             "kernels", [_nvcc(), *NVCC_FLAGS])
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
