"""ctypes bindings for the shared native host library ``csrc/sig_native.cpp``.

The library is compiled from that one source, with the flags of
``csrc/Makefile``, into ``build/native`` at first use (never into
``csrc/``).  The port binds what its slices use: the sparse state builder,
the greedy rounding scan and the block-ELL operand packers.
``native_available()`` returns False when no C++ toolchain can build it;
the state builder then falls back to the scipy path, and the rounding and
the packers raise.
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
        lib.sig_bcsr_maxblk.restype = i64
        lib.sig_bcsr_maxblk.argtypes = [i64, i64, i64, i64, pi64, pi64]
        lib.sig_bcsr_pack.restype = ctypes.c_int
        lib.sig_bcsr_pack.argtypes = [i64, i64, i64, i64, i64, pi64, pi64,
                                      pf64, pi32, vp, ctypes.c_int, vp, vp,
                                      vp, vp, vp]
        lib.sig_bcsr_gram_maps.restype = i64
        lib.sig_bcsr_gram_maps.argtypes = [i64, i64, i64, i64, pi32, pi32,
                                           pi32, pi32, i64, pi32, pi32]
        pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.sig_bcsr_sym_weights.restype = None
        lib.sig_bcsr_sym_weights.argtypes = [i64, pi64, pi64, pf32]
        lib.sig_native_num_threads.restype = ctypes.c_int
        lib.sig_native_num_threads.argtypes = []
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_num_threads() -> int:
    """The library's OpenMP thread count (0 when it did not build)."""
    lib = _load()
    return int(lib.sig_native_num_threads()) if lib is not None else 0


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


def _sorted_csr(M_csr):
    """``M_csr`` as CSR with sorted column indices, never sorting the
    caller's matrix in place (a copy is sorted when needed)."""
    M = M_csr.tocsr()
    return M if M.has_sorted_indices else M.sorted_indices()


def bcsr_pack_native(M_csr, block, pad_rows_to: Optional[int] = None,
                     dtype=None, return_entry_maps: bool = False):
    """Block-ELL arrays of a scipy CSR matrix from the C++ packer
    (``sig_bcsr_pack``), the twin of ``ops.bcsr._bcsr_arrays_np`` with the
    value cast fused into the scatter: a bfloat16 operand never exists as a
    float32 block array.

    ``dtype``: ``torch.float32`` (default) or ``torch.bfloat16``.  Returns
    ``(bcols, blocks, Kp)`` — int32 numpy [Kbr, maxblk] and a CPU tensor
    [Kbr, Br, maxblk, Bc] — or, with ``return_entry_maps``, also the int32
    numpy entry maps ``(ebr, eslot, erloc, ecloc, epos)`` in CSR entry order
    (epos is the ``s_pos`` flat position).  The slot width ``maxblk`` is
    computed here from the matrix itself, so the packer never sees a stale
    one; the maps are checked to cover every entry.  Raises RuntimeError
    when the native library is unavailable.
    """
    import math

    import torch

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native BCSR packer unavailable: {build_error}")
    dtype = torch.float32 if dtype is None else dtype
    codes = {torch.float32: (0, np.float32), torch.bfloat16: (1, np.int16)}
    if dtype not in codes:
        raise ValueError(f"native packer stores float32 or bfloat16, "
                         f"got {dtype}")
    code, store = codes[dtype]
    Br, Bc = (block, block) if isinstance(block, int) else map(int, block)
    M = _sorted_csr(M_csr)
    K = M.shape[0]
    lcm = Br * Bc // math.gcd(Br, Bc)
    Kp = pad_rows_to or ((K + lcm - 1) // lcm) * lcm
    Kbr = Kp // Br
    indptr = np.ascontiguousarray(M.indptr, np.int64)
    indices = np.ascontiguousarray(M.indices, np.int64)
    data = np.ascontiguousarray(M.data, np.float64)
    maxblk = int(lib.sig_bcsr_maxblk(K, Kp, Br, Bc, indptr, indices))
    if maxblk < 0:
        raise RuntimeError("sig_bcsr_maxblk: invalid arguments")
    if return_entry_maps and Kbr * Br * maxblk * Bc >= 2**31:
        raise ValueError("entry positions exceed int32: "
                         f"{Kbr}x{Br}x{maxblk}x{Bc} block elements")
    bcols = np.zeros((Kbr, maxblk), np.int32)
    blocks = np.zeros(Kbr * Br * maxblk * Bc, store)
    maps = [np.full(M.nnz, -1, np.int32) for _ in range(5)] \
        if return_entry_maps else []
    ptrs = [m.ctypes.data_as(ctypes.c_void_p) for m in maps] or [None] * 5
    rc = lib.sig_bcsr_pack(K, Kp, Br, Bc, maxblk, indptr, indices, data,
                           bcols, blocks.ctypes.data_as(ctypes.c_void_p),
                           code, *ptrs)
    if rc != 0:
        raise RuntimeError("sig_bcsr_pack failed")
    if maps and M.nnz and int(maps[1].min()) < 0:
        raise RuntimeError("sig_bcsr_pack left entries unplaced")
    t = torch.from_numpy(blocks.reshape(Kbr, Br, maxblk, Bc))
    if code == 1:
        t = t.view(torch.bfloat16)
    if return_entry_maps:
        return bcols, t, Kp, tuple(maps)
    return bcols, t, Kp


def bcsr_gram_maps_native(ebr: np.ndarray, eslot: np.ndarray,
                          erloc: np.ndarray, ecloc: np.ndarray,
                          maxblk: int, Br: int, Bc: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(g_src, g_dst) [maxblk, max_e] int32 from the packer's entry maps:
    the counting-sort twin of the numpy stable-argsort grouping in
    ``ops.bcsr.bcsr_operands_from_state`` (entry order kept within each
    slot; unfilled g_dst slots hold nnz, the sink)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native gram maps unavailable: {build_error}")
    nnz = int(eslot.shape[0])
    counts = np.bincount(eslot, minlength=maxblk)
    max_e = max(int(counts.max(initial=0)), 1)
    g_src = np.zeros((maxblk, max_e), np.int32)
    g_dst = np.full((maxblk, max_e), nnz, np.int32)
    rc = lib.sig_bcsr_gram_maps(
        nnz, int(maxblk), int(Br), int(Bc),
        np.ascontiguousarray(ebr, np.int32),
        np.ascontiguousarray(eslot, np.int32),
        np.ascontiguousarray(erloc, np.int32),
        np.ascontiguousarray(ecloc, np.int32), max_e, g_src, g_dst)
    if rc < 0:
        raise RuntimeError("sig_bcsr_gram_maps failed")
    return g_src, g_dst


def bcsr_sym_weights_native(M_csr) -> np.ndarray:
    """[nnz] float32 symmetrization weights in CSR entry order: 0.5 where
    the transpose entry exists, else 1.0.  The C++ loop binary-searches each
    row's columns, so the indices must be sorted: raises ValueError on an
    unsorted matrix."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native weights unavailable: {build_error}")
    M = M_csr.tocsr()
    if not M.has_sorted_indices:
        raise ValueError("symmetrization weights need sorted CSR indices")
    w = np.empty(M.nnz, np.float32)
    lib.sig_bcsr_sym_weights(M.shape[0],
                             np.ascontiguousarray(M.indptr, np.int64),
                             np.ascontiguousarray(M.indices, np.int64), w)
    return w
