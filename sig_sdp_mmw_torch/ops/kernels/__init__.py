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

The three share their tile code through ``spmm_tile.cuh``: the
tensor-core ring tile of 128x128 blocks and the short-block tensor-core tile
of every other shape, each in bfloat16 and in float32 (three tf32 products
per pair, float32 accuracy).  The entry points, one per route of
:func:`sig_sdp_mmw_torch.ops.bcsr.spmm_route`:

* ``*_bf16_launch`` ("ring": 128x128 bfloat16 blocks; for the V-resident
  kernel a TMA ring feeding wgmma);
* ``*_ring_f32_launch`` ("ring_f32": 128x128 float32 blocks; flat and
  block-ELL kernels);
* ``bsr_spmm_vres_f32_launch`` ("tma_f32": the V-resident kernel's 128x128
  float32 blocks, its TMA ring feeding three tf32 wgmma products per
  pair);
* ``*_short_launch`` ("short_bf16") and ``*_short_f32_launch``
  ("short_f32"): blocks of any other shape, Br and Bc at run time (the
  V-resident kernel's are the flat kernel's bodies).

A library's build hash covers the headers of ``csrc/`` as well as its own
source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Dict, Tuple

from sig_sdp_mmw_torch.utils.build import build_shared_library

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# --split-compile=3: each library's device code is optimised in three
# threads, so the three libraries, built at once, share the card host's 8
# cores (about 26 s instead of 57 on an H100 host, nvcc 12.9).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=3"]

_lock = threading.Lock()
_name_locks: Dict[Tuple[str, ...], threading.Lock] = {}
_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
# Compiler output of each build made by this process (ptxas register and
# shared-memory report), by kernel name (and defines, for a variant).
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


def load_kernel_library(name: str, defines: Tuple[str, ...] = ()
                        ) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``, with ``-D`` ``defines``
    for a variant (a library of its own); argtypes are set by the caller's
    binding."""
    key = (name, *defines)
    with _lock:
        lock = _name_locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _libs:
            cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines)]
            path, log = build_shared_library(os.path.join(CSRC, f"{name}.cu"),
                                             "kernels", cmd,
                                             key=_headers_digest())
            build_logs[" ".join(key)] = log
            _libs[key] = ctypes.CDLL(path)
        return _libs[key]


def bsr_spmm_flat_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = load_kernel_library("bsr_spmm_flat", defines)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bsr_spmm_flat_bf16_launch.restype = i32
    lib.bsr_spmm_flat_bf16_launch.argtypes = [vp, vp, vp, vp, i32, vp, i32,
                                              i32, i32, i32, vp]
    lib.bsr_spmm_flat_ring_f32_launch.restype = i32
    lib.bsr_spmm_flat_ring_f32_launch.argtypes = [vp, vp, vp, vp, vp, i32,
                                                  i32, i32, i32, vp]
    lib.bsr_spmm_flat_short_launch.restype = i32
    lib.bsr_spmm_flat_short_launch.argtypes = [vp, vp, vp, i32, i32, vp, i32,
                                               vp, i32, i32, i32, i32, vp]
    lib.bsr_spmm_flat_short_f32_launch.restype = i32
    lib.bsr_spmm_flat_short_f32_launch.argtypes = [vp, vp, vp, i32, i32, vp,
                                                   vp, i32, i32, i32, i32, vp]
    return lib


def bcsr_spmm_ell_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = load_kernel_library("bcsr_spmm_ell", defines)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bcsr_spmm_ell_bf16_launch.restype = i32
    lib.bcsr_spmm_ell_bf16_launch.argtypes = [vp, vp, vp, i32, vp, i64, i32,
                                              i32, i32, vp]
    lib.bcsr_spmm_ell_ring_f32_launch.restype = i32
    lib.bcsr_spmm_ell_ring_f32_launch.argtypes = [vp, vp, vp, vp, i64, i32,
                                                  i32, i32, vp]
    lib.bcsr_spmm_ell_short_launch.restype = i32
    lib.bcsr_spmm_ell_short_launch.argtypes = [vp, vp, i32, i32, vp, i32, vp,
                                               i64, i32, i32, i32, vp]
    lib.bcsr_spmm_ell_short_f32_launch.restype = i32
    lib.bcsr_spmm_ell_short_f32_launch.argtypes = [vp, vp, i32, i32, vp, vp,
                                                   i64, i32, i32, i32, vp]
    return lib


def bsr_spmm_vres_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = load_kernel_library("bsr_spmm_vres", defines)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bsr_spmm_vres_f32_launch.restype = i32
    lib.bsr_spmm_vres_f32_launch.argtypes = [vp, vp, vp, vp, vp, vp, i32,
                                             i32, i32, i32, vp]
    lib.bsr_spmm_vres_bf16_launch.restype = i32
    lib.bsr_spmm_vres_bf16_launch.argtypes = [vp, vp, vp, vp, i32, vp, vp,
                                              i32, i32, i32, i32, vp]
    lib.bsr_spmm_vres_short_launch.restype = i32
    lib.bsr_spmm_vres_short_launch.argtypes = [vp, vp, vp, i32, i32, vp, i32,
                                               vp, i32, i32, i32, i32, vp]
    lib.bsr_spmm_vres_short_f32_launch.restype = i32
    lib.bsr_spmm_vres_short_f32_launch.argtypes = [vp, vp, vp, i32, i32, vp,
                                                   vp, i32, i32, i32, i32, vp]
    return lib


# Every kernel's binding, by name (chip_smoke.py builds them all at once).
LIBRARIES = {"bsr_spmm_flat": bsr_spmm_flat_library,
             "bcsr_spmm_ell": bcsr_spmm_ell_library,
             "bsr_spmm_vres": bsr_spmm_vres_library}
