"""ctypes bindings for the shared native host library ``csrc/sig_native.cpp``.

The library is compiled from that one source, with the flags of
``csrc/Makefile``, into ``build/native`` at first use (never into
``csrc/``).  The port binds what its slice uses: the sparse state builder
and the greedy rounding scan.  ``native_available()`` returns False when no
C++ toolchain can build it; the state builder then falls back to the scipy
path, and the rounding raises.
"""

from __future__ import annotations

import ctypes
import os
import platform
import shlex
import shutil
import threading
from typing import Optional, Tuple

import numpy as np

from sig_sdp_mmw_torch.utils.build import REPO_ROOT, build_shared_library

_SRC = os.path.join(REPO_ROOT, "csrc", "sig_native.cpp")
# csrc/Makefile: CXXFLAGS ?= -O3 -march=native -fPIC -shared -std=c++17
# -fopenmp -Wall
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-fopenmp", "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None   # why the library did not build, if not


def _compilers() -> list:
    """$CXX when it names a compiler that exists, then g++ (the Makefile's
    default): a $CXX without OpenMP support falls through to g++."""
    cxx = shlex.split(os.environ.get("CXX", ""))
    return ([cxx] if cxx and shutil.which(cxx[0]) else []) + [["g++"]]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        errors = []
        for cxx in _compilers():
            try:
                # -march=native code is specific to the host that built it.
                path, _ = build_shared_library(_SRC, "native",
                                               [*cxx, *_CXXFLAGS],
                                               key=platform.node())
                lib = ctypes.CDLL(path)
                break
            except (OSError, RuntimeError) as e:
                errors.append(str(e))
        else:
            build_error = "\n".join(errors)
            return None
        i64, f64, vp = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
        pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.sig_build_state.restype = vp
        lib.sig_build_state.argtypes = [i64, i64, f64, f64, pf64, f64, f64,
                                        f64, f64, f64, f64, f64]
        lib.sig_state_nnz_s.restype = i64
        lib.sig_state_nnz_s.argtypes = [vp]
        lib.sig_state_nnz_q.restype = i64
        lib.sig_state_nnz_q.argtypes = [vp]
        lib.sig_state_export.restype = None
        lib.sig_state_export.argtypes = [vp, pi64, pi64, pf64, pi64, pi64,
                                         pf64, pi64]
        lib.sig_state_free.restype = None
        lib.sig_state_free.argtypes = [vp]
        lib.sig_greedy_round.restype = i64
        lib.sig_greedy_round.argtypes = [i64, i64, pi64, pi64, pf64, pi64,
                                         pi64, pf64, pi64, pi32, pi32]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_state_csr_native(sta_locs: np.ndarray, params, cutoff: float
                           ) -> Tuple["object", "object", np.ndarray,
                                      np.ndarray]:
    """(S_csr, Q_csr, h_max, asso) from user coordinates via the C++ builder.

    ``sta_locs`` must already be in the caller's order; ``params`` is an
    :class:`sig_sdp_mmw_torch.env.env.EnvParams`.  Raises RuntimeError if
    the native library is unavailable.
    """
    import scipy.sparse

    from sig_sdp_mmw_torch.env import phy

    lib = _load()
    if lib is None:
        raise RuntimeError("native builder unavailable (no C++ toolchain?)")
    p = params
    K = int(sta_locs.shape[0])
    xy = np.ascontiguousarray(sta_locs, dtype=np.float64)
    h = lib.sig_build_state(
        K, int(p.cell_size), float(p.cell_edge), float(p.grid_edge), xy,
        float(p.fre_Hz), float(phy.noise_dbm(p.bandwidth)),
        float(p.min_sinr_db), float(p.min_sinr), float(p.txp_offset),
        float(p.min_s_n_ratio), float(cutoff))
    if not h:
        raise RuntimeError("sig_build_state failed")
    try:
        nnz_s = lib.sig_state_nnz_s(h)
        nnz_q = lib.sig_state_nnz_q(h)
        S_indptr = np.empty(K + 1, np.int64)
        S_indices = np.empty(nnz_s, np.int64)
        S_data = np.empty(nnz_s, np.float64)
        Q_indptr = np.empty(K + 1, np.int64)
        Q_indices = np.empty(nnz_q, np.int64)
        h_max = np.empty(K, np.float64)
        asso = np.empty(K, np.int64)
        lib.sig_state_export(h, S_indptr, S_indices, S_data, Q_indptr,
                             Q_indices, h_max, asso)
    finally:
        lib.sig_state_free(h)

    S = scipy.sparse.csr_matrix((S_data, S_indices, S_indptr), shape=(K, K))
    Q = scipy.sparse.csr_matrix((np.ones(nnz_q), Q_indices, Q_indptr),
                                shape=(K, K))
    return S, Q, h_max, asso


def greedy_round_native(StT_csr, Q_csr, h_max: np.ndarray,
                        user_order: np.ndarray, slot_order: np.ndarray,
                        Z: int) -> Tuple[np.ndarray, int]:
    """One greedy rounding scan via the C++ loop (``sig_greedy_round``).

    ``StT_csr``: CSR whose row k lists k's S-row neighbours with gains
    S[k, j]; ``slot_order`` [K, Z] int32 slots in decreasing preference.
    Returns (slot_of int32 with -1 unassigned, remainder).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native rounding unavailable (no C++ toolchain?)")
    K = StT_csr.shape[0]
    slot_order = np.ascontiguousarray(slot_order, np.int32)
    user_order = np.ascontiguousarray(user_order, np.int64)
    if slot_order.shape != (K, int(Z)):
        raise ValueError(f"slot_order must be [{K}, {Z}], "
                         f"got {slot_order.shape}")
    if (user_order.shape != (K,) or np.asarray(h_max).shape != (K,)
            or Q_csr.shape != (K, K)):
        raise ValueError("user_order, h_max and Q must match K")
    if K and (user_order.min() < 0 or user_order.max() >= K):
        raise ValueError("user_order holds an index outside [0, K)")
    slot_of = np.empty(K, np.int32)
    rem = lib.sig_greedy_round(
        K, int(Z),
        np.ascontiguousarray(StT_csr.indptr, np.int64),
        np.ascontiguousarray(StT_csr.indices, np.int64),
        np.ascontiguousarray(StT_csr.data, np.float64),
        np.ascontiguousarray(Q_csr.indptr, np.int64),
        np.ascontiguousarray(Q_csr.indices, np.int64),
        np.ascontiguousarray(h_max, np.float64), user_order, slot_order,
        slot_of)
    if rem < 0:
        raise RuntimeError("sig_greedy_round: invalid arguments")
    return slot_of, int(rem)
