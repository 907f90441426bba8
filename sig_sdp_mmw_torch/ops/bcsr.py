"""Block-sparse operators of the large-graph MMW path, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.ops.bcsr`.  The interference graph, with users
in Hilbert-curve order (:func:`hilbert_order`), is banded, so it is stored as
dense 128x128 blocks of which only a few percent of entries are nonzero:

* :class:`BlockEll` — block-ELL, every block-row padded to the same slot
  count; its product is the hand-written CUDA kernel
  ``ops/kernels/csrc/bcsr_spmm_ell.cu`` behind :func:`bcsr_spmm`, with
  :func:`bcsr_spmm_reference` as its plain version; the transpose product
  and the pattern Gram are plain torch (:func:`bcsr_spmm_transpose`,
  :func:`bcsr_edge_gram_accum`);
* :class:`FlatBsr` — flat block-CSR, only real blocks, grouped ``G`` per
  step; its products are the CUDA kernels ``bsr_spmm_flat.cu`` behind
  :func:`bsr_spmm_flat` and ``bsr_spmm_vres.cu`` (V resident in L2) behind
  :func:`bsr_spmm_vres`, both with :func:`bsr_spmm_flat_reference` as their
  plain version.

Each kernel wrapper takes the plain version for a CPU tensor and, for a CUDA
tensor, launches its kernel or raises; ``<wrapper>.launches`` counts its
launches.  The host packers are numpy (above ``_NATIVE_PACK_MIN_NNZ``
nonzeros, the shared C++ packer) and give the JAX package's arrays exactly;
the containers hold tensors and move with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sig_sdp_mmw_torch.utils.tensors import TensorFields, as_tensor


def _block_pair(block) -> Tuple[int, int]:
    """Normalize a block spec to (Brow, Bcol)."""
    if isinstance(block, (tuple, list)):
        return int(block[0]), int(block[1])
    return int(block), int(block)


@dataclasses.dataclass(frozen=True)
class BlockEll(TensorFields):
    """Block-ELL sparse matrix.  ``blocks`` is stored [Kbr, Brow, maxblk,
    Bcol] so that (maxblk, Bcol) flattens into one contraction axis."""

    bcols: torch.Tensor    # [Kbr, maxblk] int32 — column-block indices
    blocks: torch.Tensor   # [Kbr, Brow, maxblk, Bcol] — dense block values
    nrows: int

    @property
    def B(self) -> int:           # Bcol (column width of a block)
        return self.blocks.shape[-1]

    @property
    def Brow(self) -> int:
        return self.blocks.shape[1]

    @property
    def Kb(self) -> int:
        return self.bcols.shape[0]


def _bcsr_arrays_np(M, block=128, pad_rows_to: int = None,
                    dtype=np.float32, return_entry_maps: bool = False):
    """Host-side BlockEll arrays (numpy) from a scipy CSR matrix.

    ``block`` may be an int (square) or a (Brow, Bcol) tuple.  With
    ``return_entry_maps`` also returns, per nonzero (in the matrix's COO
    order), its (block-row, slot, local-row, local-col)."""
    Br, Bc = _block_pair(block)
    M = M.tocsr()
    K = M.shape[0]
    lcm = Br * Bc // math.gcd(Br, Bc)
    Kp = pad_rows_to or ((K + lcm - 1) // lcm) * lcm
    Kbr = Kp // Br
    Kbc = Kp // Bc

    coo = M.tocoo()
    br = coo.row.astype(np.int64) // Br
    bc = coo.col.astype(np.int64) // Bc
    blk_id = br * Kbc + bc
    uniq, inv = np.unique(blk_id, return_inverse=True)
    ubr, ubc = uniq // Kbc, uniq % Kbc

    counts = np.bincount(ubr, minlength=Kbr)
    maxblk = max(int(counts.max(initial=0)), 1)

    bcols = np.zeros((Kbr, maxblk), np.int32)
    slot_of_uniq = np.zeros(uniq.size, np.int64)
    starts = np.zeros(Kbr + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(ubr, kind="stable")
    slots = np.arange(uniq.size) - starts[ubr[order]]
    slot_of_uniq[order] = slots
    bcols[ubr[order], slots] = ubc[order]

    slot_of_entry = slot_of_uniq[inv]
    rloc = coo.row % Br
    cloc = coo.col % Bc
    pos = ((br * Br + rloc) * maxblk + slot_of_entry) * Bc + cloc
    blocks = np.zeros(Kbr * Br * maxblk * Bc, dtype)
    blocks[pos] = coo.data
    blocks = blocks.reshape(Kbr, Br, maxblk, Bc)
    if return_entry_maps:
        return bcols, blocks, Kp, (br, slot_of_entry, rloc, cloc)
    return bcols, blocks, Kp


def _cast_f32(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """float32 host array -> ``dtype`` tensor on ``device`` (the same
    round-to-nearest-even cast the JAX package makes on the host)."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)
                            ).to(device=device, dtype=dtype)


# Above this nnz the block-ELL packing goes through the shared C++ packer
# (bit-identical to the numpy path; tests/test_torch_native.py holds them
# equal with the threshold lowered).  At a million links the numpy path
# would build two 6.2 GB float32 block arrays on the host.
_NATIVE_PACK_MIN_NNZ = 1 << 20


def bcsr_from_csr(M, block: int = 128, pad_rows_to: int = None,
                  dtype=torch.float32, device="cpu") -> BlockEll:
    """Convert a scipy CSR matrix to BlockEll (through the native packer
    above ``_NATIVE_PACK_MIN_NNZ`` nonzeros, for float32 and bfloat16
    blocks: the same arrays, without a float32 copy of a bfloat16
    operand)."""
    if M.nnz > _NATIVE_PACK_MIN_NNZ and dtype in _KERNEL_BLOCK_DTYPES:
        from sig_sdp_mmw_torch.native.builder import bcsr_pack_native

        bcols, blocks, Kp = bcsr_pack_native(M, block, pad_rows_to, dtype)
        return BlockEll(bcols=torch.from_numpy(bcols).to(device),
                        blocks=blocks.to(device), nrows=Kp)
    bcols, blocks, Kp = _bcsr_arrays_np(M, block, pad_rows_to, np.float32)
    return BlockEll(bcols=torch.from_numpy(bcols).to(device),
                    blocks=_cast_f32(blocks, dtype, device), nrows=Kp)


def _row_chunks(Kbr: int, row_chunk: Optional[int]):
    """[start, stop) ranges of block-rows, ``row_chunk`` at a time (one
    range when None)."""
    step = Kbr if row_chunk is None else max(int(row_chunk), 1)
    return [(i, min(i + step, Kbr)) for i in range(0, Kbr, step)]


def bcsr_spmm_reference(mat: BlockEll, V: torch.Tensor,
                        row_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch ``A @ V`` on block-ELL: a gather of V column-blocks and
    one batched matmul per chunk of ``row_chunk`` block-rows (None: one
    chunk), so the float copy of the blocks and the gathered V stack stay
    [row_chunk, ...] at large K.  V is cast to the block dtype first and the
    product accumulates in V's dtype, as the TPU kernel does."""
    Br, Bc = mat.Brow, mat.B
    Kbr = mat.Kb
    Kbc = mat.nrows // Bc
    D = V.shape[1]
    acc = V.dtype
    maxblk = mat.bcols.shape[1]
    Vb = V.to(mat.blocks.dtype).to(acc).reshape(Kbc, Bc, D)
    out = torch.empty((Kbr, Br, D), dtype=acc, device=V.device)
    for i, j in _row_chunks(Kbr, row_chunk):
        R = Vb[mat.bcols[i:j]].reshape(j - i, maxblk * Bc, D)
        A = mat.blocks[i:j].to(acc).reshape(j - i, Br, maxblk * Bc)
        torch.bmm(A, R, out=out[i:j])
    return out.reshape(Kbr * Br, D)


def ell_kernel_unsupported(mat: BlockEll, V: torch.Tensor) -> Optional[str]:
    """Why the block-ELL CUDA kernel cannot take these operands (None if it
    can).  :func:`bcsr_spmm` pads V's columns to a multiple of 8 first."""
    if mat.Brow not in (8, 128) or mat.B != 128:
        return f"blocks must be 128x128 or 8x128, got {mat.Brow}x{mat.B}"
    if mat.blocks.dtype not in _KERNEL_BLOCK_DTYPES:
        return f"blocks must be float32 or bfloat16, got {mat.blocks.dtype}"
    if (mat.blocks.dim() != 4 or mat.blocks.shape[0] != mat.Kb
            or mat.blocks.shape[2] != mat.bcols.shape[1]
            or mat.nrows != mat.Kb * mat.Brow):
        return (f"blocks {list(mat.blocks.shape)} do not match bcols "
                f"{list(mat.bcols.shape)} and nrows {mat.nrows}")
    if V.dtype != torch.float32:
        return f"V must be float32, got {V.dtype}"
    if V.dim() != 2 or V.shape[0] != mat.nrows:
        return f"V must be [{mat.nrows}, D], got {list(V.shape)}"
    if V.shape[1] == 0 or V.shape[1] % 8:
        return f"D must be a positive multiple of 8, got {V.shape[1]}"
    if mat.bcols.dtype != torch.int32:
        return f"bcols must be torch.int32, got {mat.bcols.dtype}"
    for name, t in (("blocks", mat.blocks), ("bcols", mat.bcols), ("V", V)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.device != V.device:
            return f"{name} is on {t.device}, V on {V.device}"
        if t.data_ptr() % 16:
            return f"{name} must be 16-byte aligned"
    return None


def bcsr_spmm(mat: BlockEll, V: torch.Tensor,
              row_chunk: Optional[int] = None) -> torch.Tensor:
    """BlockEll [Kp, Kp] x [Kp, D] -> [Kp, D].  A CPU tensor goes to the
    plain version (``row_chunk`` bounds its transients); a CUDA tensor
    launches the block-ELL kernel on the current stream, which needs no
    chunking, or raises.  V's columns are padded with zeros to a multiple of
    8 for the kernel (the gap Lanczos sends D=1) and the result is sliced
    back.  ``bcsr_spmm.launches`` counts kernel launches."""
    if V.device.type == "cpu":
        return bcsr_spmm_reference(mat, V, row_chunk)
    if V.device.type != "cuda":
        raise ValueError(f"bcsr_spmm: no kernel for device {V.device}")
    D = V.shape[1] if V.dim() == 2 else 0
    Vk = F.pad(V, (0, -D % 8)) if D % 8 else V.contiguous()
    why = ell_kernel_unsupported(mat, Vk)
    if why is not None:
        raise ValueError(f"bcsr_spmm: {why}")
    from sig_sdp_mmw_torch.ops.kernels import bcsr_spmm_ell_library

    lib = bcsr_spmm_ell_library()
    out = torch.empty((mat.nrows, Vk.shape[1]), dtype=torch.float32,
                      device=V.device)
    with torch.cuda.device(V.device):
        rc = lib.bcsr_spmm_ell_launch(
            mat.bcols.data_ptr(), mat.blocks.data_ptr(),
            _KERNEL_BLOCK_DTYPES[mat.blocks.dtype], mat.Brow, Vk.data_ptr(),
            out.data_ptr(), mat.Kb, mat.bcols.shape[1], Vk.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm: launch failed with cudaError {rc}")
    bcsr_spmm.launches += 1
    return out if Vk.shape[1] == D else out[:, :D]


bcsr_spmm.launches = 0


def bcsr_spmm_transpose(mat_bcols: torch.Tensor, blocks: torch.Tensor,
                        V: torch.Tensor,
                        row_chunk: Optional[int] = None) -> torch.Tensor:
    """``A^T @ V`` with A in BlockEll form (bcols, blocks): every
    per-(row, slot) contribution ``blocks[k, :, s, :]^T @ Vr[k]`` from one
    batched product per chunk of ``row_chunk`` block-rows (None: one chunk),
    scatter-added into the output column blocks.  Plain torch on every
    device (the JAX package's is an XLA scatter-add, not a Pallas kernel).
    On CUDA the scatter-add order varies from run to run (float sums differ
    in the last bits)."""
    Kbr, maxblk = mat_bcols.shape
    Br, Bc = blocks.shape[1], blocks.shape[-1]
    nrows = Kbr * Br
    Kbc = nrows // Bc
    D = V.shape[1]
    acc = V.dtype
    Vr = V.to(blocks.dtype).to(acc).reshape(Kbr, Br, D)
    seg = torch.zeros((Kbc, Bc, D), dtype=acc, device=V.device)
    for i, j in _row_chunks(Kbr, row_chunk):
        c = torch.einsum("krsc,krd->kscd", blocks[i:j].to(acc), Vr[i:j])
        seg.index_add_(0, mat_bcols[i:j].reshape(-1),
                       c.reshape((j - i) * maxblk, Bc, D))
    return seg.reshape(nrows, D)


def bcsr_edge_gram_accum(bcols: torch.Tensor, Xr: torch.Tensor,
                         Xc: torch.Tensor, g_src: torch.Tensor,
                         g_dst: torch.Tensor, acc: torch.Tensor,
                         scale) -> torch.Tensor:
    """``acc[e] += scale * <X[i_e], X[j_e]>`` for every nonzero e of the
    block pattern, slot by slot: one batched [Br, D] x [Bc, D]^T product per
    slot gives the block Gram, whose pattern entries ``g_src[s]`` are
    scatter-added at ``g_dst[s]`` (padding targets the sink ``acc[-1]``).

    Updates ``acc`` in place (it is the solver's O(nnz) carry, replaced
    every iteration) and returns it.

    Args:
      Xr: [Kbr, Br, D] row-blocked X;  Xc: [Kbc, Bc, D] column-blocked X.
      g_src/g_dst: [maxblk, max_e] int32 maps from
        :func:`bcsr_operands_from_state`.
      acc: [nnz + 1] accumulator (last element = padding sink).
    """
    for s in range(bcols.shape[1]):
        G = torch.bmm(Xr, Xc[bcols[:, s]].transpose(1, 2)).to(acc.dtype)
        acc.index_add_(0, g_dst[s], scale * G.reshape(-1)[g_src[s]])
    return acc


@dataclasses.dataclass(frozen=True)
class FlatBsr(TensorFields):
    """Flat block-CSR sparse matrix: only the blocks that exist are stored,
    in block-CSR order, ``G`` per step; each block-row's block count is
    padded to a multiple of G with zero blocks at column-block 0.

    ``brows[i]`` is the block-row of step i; the steps of one block-row are
    consecutive, and ``row_ptr`` [Kbr+1] (derived from ``brows`` once, at
    construction) holds each block-row's first step — the kernel's row
    index."""

    brows: torch.Tensor    # [nsteps] int32 — block-row id per step
    bcols: torch.Tensor    # [nsteps*G] int32 — column-block ids, flat
    blocks: torch.Tensor   # [nsteps, Br, G*Bc] — G dense blocks side by side
    row_ptr: torch.Tensor  # [Kbr+1] int32 — first step of each block-row
    nrows: int

    @property
    def G(self) -> int:
        return self.bcols.shape[0] // self.brows.shape[0]

    @property
    def Br(self) -> int:
        return self.blocks.shape[1]

    @property
    def Bc(self) -> int:
        return self.blocks.shape[2] // self.G

    @property
    def nsteps(self) -> int:
        return self.brows.shape[0]

    @property
    def Kbr(self) -> int:
        return self.row_ptr.shape[0] - 1


def flat_bsr(brows: np.ndarray, bcols: np.ndarray, blocks: torch.Tensor,
             nrows: int) -> FlatBsr:
    """FlatBsr from host step arrays, deriving and checking ``row_ptr``:
    steps must be sorted by block-row, and every block-row must own at least
    one step (the kernel writes each output row-block from its own steps)."""
    brows = np.array(brows, np.int32)
    Br = blocks.shape[1]
    Kbr = nrows // Br
    if brows.size and (np.any(np.diff(brows) < 0) or brows[0] < 0
                       or brows[-1] >= Kbr):
        raise ValueError("FlatBsr steps must be sorted by block-row "
                         f"in [0, {Kbr})")
    row_ptr = np.searchsorted(brows, np.arange(Kbr + 1)).astype(np.int32)
    if np.any(np.diff(row_ptr) < 1):
        raise ValueError("every block-row of a FlatBsr needs at least one step")
    device = blocks.device
    return FlatBsr(brows=torch.from_numpy(brows).to(device),
                   bcols=torch.from_numpy(np.array(bcols, np.int32)
                                          ).to(device),
                   blocks=blocks, row_ptr=torch.from_numpy(row_ptr).to(device),
                   nrows=int(nrows))


def bsr_flat_from_csr(M, block=128, group: int = 4,
                      pad_rows_to: Optional[int] = None,
                      dtype=torch.float32, device="cpu") -> FlatBsr:
    """Host-side flat block-CSR build from a scipy CSR matrix.

    Every block-row gets at least one group, and its block list is padded to
    a multiple of ``group`` with zero blocks targeting column-block 0.
    """
    Br, Bc = _block_pair(block)
    M = M.tocsr()
    K = M.shape[0]
    lcm = Br * Bc // math.gcd(Br, Bc)
    Kp = pad_rows_to or ((K + lcm - 1) // lcm) * lcm
    Kbr = Kp // Br
    Kbc = Kp // Bc

    coo = M.tocoo()
    br = coo.row.astype(np.int64) // Br
    bc = coo.col.astype(np.int64) // Bc
    blk_id = br * Kbc + bc
    uniq, inv = np.unique(blk_id, return_inverse=True)
    ubr, ubc = uniq // Kbc, uniq % Kbc

    counts = np.bincount(ubr, minlength=Kbr)          # blocks per block-row
    padded = np.maximum(np.ceil(counts / group).astype(np.int64), 1) * group
    starts = np.zeros(Kbr + 1, np.int64)
    np.cumsum(padded, out=starts[1:])
    nblk_pad = int(starts[-1])
    nsteps = nblk_pad // group

    order = np.argsort(ubr, kind="stable")
    within = np.arange(uniq.size) - np.concatenate(
        ([0], np.cumsum(np.bincount(ubr, minlength=Kbr))))[ubr[order]]
    slot_of_uniq = np.empty(uniq.size, np.int64)
    slot_of_uniq[order] = starts[ubr[order]] + within

    bcols = np.zeros(nblk_pad, np.int32)
    bcols[slot_of_uniq] = ubc
    brows = np.repeat(np.arange(Kbr, dtype=np.int32), padded // group)

    # float64 values go in at float64; narrower dtypes round through float32
    # first, which is what the JAX packer's bfloat16 assignment does.
    host = np.float64 if dtype == torch.float64 else np.float32
    blocks = np.zeros((nblk_pad, Br, Bc), host)
    blocks[slot_of_uniq[inv], coo.row % Br, coo.col % Bc] = coo.data
    blocks = np.ascontiguousarray(
        blocks.reshape(nsteps, group, Br, Bc).transpose(0, 2, 1, 3)
        .reshape(nsteps, Br, group * Bc))
    return flat_bsr(brows, bcols,
                    torch.from_numpy(blocks).to(device=device, dtype=dtype),
                    Kp)


# ---------------------------------------------------------------------------
# Flat block-CSR SpMM: the hand-written kernel and its plain version
# ---------------------------------------------------------------------------

def bsr_spmm_flat_reference(mat: FlatBsr, V: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``A @ V`` on flat block-CSR: gather V's column-blocks
    by ``bcols``, one batched product per step, ``index_add_`` over
    ``brows``.  V is cast to the block dtype first and the sum accumulates
    in V's dtype, as the TPU kernel does."""
    G, Br, Bc = mat.G, mat.Br, mat.Bc
    D = V.shape[1]
    acc = V.dtype
    Vb = V.to(mat.blocks.dtype).to(acc).reshape(mat.nrows // Bc, Bc, D)
    R = Vb[mat.bcols].reshape(mat.nsteps, G * Bc, D)
    prod = torch.einsum("sik,skd->sid", mat.blocks.to(acc), R)
    out = torch.zeros((mat.nrows // Br, Br, D), dtype=acc, device=V.device)
    out.index_add_(0, mat.brows, prod)
    return out.reshape(mat.nrows, D)


_KERNEL_BLOCK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flat_kernel_unsupported(mat: FlatBsr, V: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel cannot take these operands (None if it can)."""
    if mat.Br != 128 or mat.Bc != 128:
        return f"blocks must be 128x128, got {mat.Br}x{mat.Bc}"
    if mat.blocks.dtype not in _KERNEL_BLOCK_DTYPES:
        return f"blocks must be float32 or bfloat16, got {mat.blocks.dtype}"
    if V.dtype != torch.float32:
        return f"V must be float32, got {V.dtype}"
    if V.dim() != 2 or V.shape[0] != mat.nrows:
        return f"V must be [{mat.nrows}, D], got {list(V.shape)}"
    if V.shape[1] == 0 or V.shape[1] % 8:
        return f"D must be a positive multiple of 8, got {V.shape[1]}"
    for name, t, dt in (("row_ptr", mat.row_ptr, torch.int32),
                        ("bcols", mat.bcols, torch.int32)):
        if t.dtype != dt:
            return f"{name} must be {dt}, got {t.dtype}"
    for name, t in (("blocks", mat.blocks), ("bcols", mat.bcols),
                    ("row_ptr", mat.row_ptr), ("V", V)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.device != V.device:
            return f"{name} is on {t.device}, V on {V.device}"
        if t.data_ptr() % 16:
            return f"{name} must be 16-byte aligned"
    return None


def bsr_spmm_flat(mat: FlatBsr, V: torch.Tensor) -> torch.Tensor:
    """``A @ V`` on flat block-CSR.  A CPU tensor goes to the plain version;
    a CUDA tensor launches the kernel on the current stream, or raises.
    ``bsr_spmm_flat.launches`` counts kernel launches."""
    if V.device.type == "cpu":
        return bsr_spmm_flat_reference(mat, V)
    if V.device.type != "cuda":
        raise ValueError(f"bsr_spmm_flat: no kernel for device {V.device}")
    why = flat_kernel_unsupported(mat, V)
    if why is not None:
        raise ValueError(f"bsr_spmm_flat: {why}")
    from sig_sdp_mmw_torch.ops.kernels import bsr_spmm_flat_library

    lib = bsr_spmm_flat_library()
    out = torch.empty((mat.nrows, V.shape[1]), dtype=torch.float32,
                      device=V.device)
    with torch.cuda.device(V.device):
        rc = lib.bsr_spmm_flat_launch(
            mat.row_ptr.data_ptr(), mat.bcols.data_ptr(),
            mat.blocks.data_ptr(), _KERNEL_BLOCK_DTYPES[mat.blocks.dtype],
            V.data_ptr(), out.data_ptr(), mat.Kbr, mat.G, V.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm_flat: launch failed with cudaError {rc}")
    bsr_spmm_flat.launches += 1
    return out


bsr_spmm_flat.launches = 0


def bsr_spmm_vres(mat: FlatBsr, V: torch.Tensor) -> torch.Tensor:
    """``A @ V`` on flat block-CSR with V resident in L2 (the Hopper form of
    the TPU kernel's VMEM-resident V, see ``bsr_spmm_vres.cu``).  Same
    contract and plain version as :func:`bsr_spmm_flat`.  On CUDA, V is
    cast to the block dtype once here, and that copy is what the kernel
    keeps in L2; ``bsr_spmm_vres.launches`` counts kernel launches."""
    if V.device.type == "cpu":
        return bsr_spmm_flat_reference(mat, V)
    if V.device.type != "cuda":
        raise ValueError(f"bsr_spmm_vres: no kernel for device {V.device}")
    why = flat_kernel_unsupported(mat, V)
    if why is None and mat.blocks.data_ptr() % 32:
        why = "blocks must be 32-byte aligned"   # tensor-core loads from HBM
    if why is not None:
        raise ValueError(f"bsr_spmm_vres: {why}")
    from sig_sdp_mmw_torch.ops.kernels import bsr_spmm_vres_library

    lib = bsr_spmm_vres_library()
    Vc = V.to(mat.blocks.dtype)
    out = torch.empty((mat.nrows, V.shape[1]), dtype=torch.float32,
                      device=V.device)
    with torch.cuda.device(V.device):
        rc = lib.bsr_spmm_vres_launch(
            mat.row_ptr.data_ptr(), mat.bcols.data_ptr(),
            mat.blocks.data_ptr(), _KERNEL_BLOCK_DTYPES[mat.blocks.dtype],
            Vc.data_ptr(), Vc.numel() * Vc.element_size(), out.data_ptr(),
            mat.Kbr, mat.G, V.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm_vres: launch failed with cudaError {rc}")
    bsr_spmm_vres.launches += 1
    return out


bsr_spmm_vres.launches = 0


# ---------------------------------------------------------------------------
# Operands of the block-native MMW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BcsrOperands(TensorFields):
    """Everything the block-native MMW needs (see models/mmw_ell.py):

    * ``s_blocks`` / ``st_blocks`` — S tilde and its transpose as BlockEll
      (``st_blocks`` None: the transpose matvec scatters through
      ``s_blocks``);
    * edge-level Gram maps ``g_src``/``g_dst`` [maxblk, max_e], the
      symmetrization weights ``w_edge`` [nnz] (1 one-way / 0.5
      bidirectional) and ``s_pos`` [nnz], flat positions into
      [Kbr, Br, maxblk, Bc];
    * association-edge block layout ``q_bcols`` with scatter positions
      ``q_pos`` and source edge ids ``q_eidx``;
    * optional flat block-CSR twins ``s_flat``/``st_flat`` of (S̃, S̃ᵀ):
      when present, the solver's S̃ and S̃ᵀ matvecs go through
      :func:`bsr_spmm_flat`.
    """

    s_blocks: BlockEll
    st_blocks: Optional[BlockEll]
    g_src: torch.Tensor     # [maxblk, max_e] int32
    g_dst: torch.Tensor     # [maxblk, max_e] int32 (nnz = sink)
    w_edge: torch.Tensor    # [nnz] (values exactly 1.0/0.5)
    s_pos: torch.Tensor     # [nnz] int32
    q_bcols: torch.Tensor   # [Kbr, maxblkQ] int32
    q_pos: torch.Tensor     # [2E] int32 flat positions into the q block array
    q_eidx: torch.Tensor    # [2E] int32 indices into the ut edge value vector
    s_flat: Optional[FlatBsr] = None
    st_flat: Optional[FlatBsr] = None

    @property
    def nnz(self) -> int:
        return self.w_edge.shape[0]


def bcsr_operands_from_state(S_csr, Q_csr, block=(8, 128),
                             dtype=torch.float32,
                             store_transpose: bool = False,
                             weights_dtype=torch.float32,
                             pad_rows_to: Optional[int] = None,
                             flat_group: Optional[int] = None,
                             device="cpu") -> BcsrOperands:
    """Host build of the block operands, then one move to ``device``.

    ``block``: (Brow, Bcol) or int.  ``dtype``: storage dtype of the value
    blocks (bfloat16 halves the bytes; products still accumulate in
    float32).  ``store_transpose=False`` runs S̃ᵀ matvecs as scatter-adds
    through ``s_blocks``.  ``flat_group`` also builds the flat block-CSR
    twins that route S̃ and S̃ᵀ matvecs through the flat CUDA kernel.
    Above ``_NATIVE_PACK_MIN_NNZ`` nonzeros (float32 and bfloat16 blocks)
    the block arrays, Gram maps and symmetrization weights come from the
    native packer, which must build: it raises otherwise.
    """
    import scipy.sparse

    from sig_sdp_mmw_torch.core.ell import build_st_csr

    Br, Bc = _block_pair(block)
    St = build_st_csr(S_csr, Q_csr)
    St.sort_indices()
    K = St.shape[0]
    lcm = Br * Bc // math.gcd(Br, Bc)
    nr = ((K + lcm - 1) // lcm) * lcm
    if pad_rows_to is not None:
        if pad_rows_to < nr or pad_rows_to % lcm:
            raise ValueError(f"pad_rows_to must be a multiple of {lcm} "
                             f">= {nr}, got {pad_rows_to}")
        nr = pad_rows_to
    Kbr = nr // Br
    Kbc = nr // Bc
    nnz = St.nnz
    StT = St.transpose().tocsr()
    if nnz > _NATIVE_PACK_MIN_NNZ and dtype in _KERNEL_BLOCK_DTYPES:
        from sig_sdp_mmw_torch.native.builder import (bcsr_gram_maps_native,
                                                      bcsr_pack_native,
                                                      bcsr_sym_weights_native)

        s_bcols, s_vals, _, (ebr, eslot, erloc, ecloc, s_pos) = \
            bcsr_pack_native(St, (Br, Bc), nr, dtype, return_entry_maps=True)
        s_blocks = BlockEll(bcols=torch.from_numpy(s_bcols), blocks=s_vals,
                            nrows=nr)
        maxblk = s_bcols.shape[1]
        # Counting-sort grouping and entrywise transpose lookup in C++.
        g_src, g_dst = bcsr_gram_maps_native(ebr, eslot, erloc, ecloc,
                                             maxblk, Br, Bc)
        del ebr, eslot, erloc, ecloc
        w_edge = bcsr_sym_weights_native(St)
        st_blocks = (bcsr_from_csr(StT, (Br, Bc), nr, dtype)
                     if store_transpose else None)
    else:
        s_bcols, s_vals_np, _, (ebr, eslot, erloc, ecloc) = _bcsr_arrays_np(
            St, (Br, Bc), pad_rows_to=nr, dtype=np.float32,
            return_entry_maps=True)
        maxblk = s_bcols.shape[1]

        # Edge-level Gram maps (entry order = St COO order = CSR sorted).
        src_pos = ((ebr * Br + erloc) * Bc + ecloc).astype(np.int64)
        counts_s = np.bincount(eslot, minlength=maxblk)
        max_e = max(int(counts_s.max(initial=0)), 1)
        g_src = np.zeros((maxblk, max_e), np.int32)
        g_dst = np.full((maxblk, max_e), nnz, np.int32)  # sink by default
        order = np.argsort(eslot, kind="stable")
        within = np.arange(nnz) - np.concatenate(
            ([0], np.cumsum(counts_s)))[eslot[order]]
        g_src[eslot[order], within] = src_pos[order]
        g_dst[eslot[order], within] = np.arange(nnz)[order]
        s_pos = (((ebr * Br + erloc) * maxblk + eslot) * Bc
                 + ecloc).astype(np.int32)

        # Symmetrization weights, aligned with St's CSR entry order.
        P = St.copy()
        P.data = np.ones_like(P.data)
        B2 = P.multiply(P.transpose()).tocsr()
        Wm = (P - 0.5 * B2).tocsr()
        Wm.sort_indices()
        if not (np.array_equal(Wm.indices, St.indices)
                and np.array_equal(Wm.indptr, St.indptr)):
            raise AssertionError("weight/value edge orders diverged")
        w_edge = Wm.data.astype(np.float32)

        s_blocks = BlockEll(bcols=torch.from_numpy(s_bcols),
                            blocks=_cast_f32(s_vals_np, dtype, "cpu"),
                            nrows=nr)
        del s_vals_np
        st_blocks = None
        if store_transpose:
            st_bcols, st_vals_np, _ = _bcsr_arrays_np(StT, (Br, Bc),
                                                      pad_rows_to=nr,
                                                      dtype=np.float32)
            st_blocks = BlockEll(bcols=torch.from_numpy(st_bcols),
                                 blocks=_cast_f32(st_vals_np, dtype, "cpu"),
                                 nrows=nr)
            del st_vals_np

    # Association edges -> block scatter layout.
    Qu = scipy.sparse.triu(Q_csr.tocsr(), k=1).tocoo()
    E = Qu.nnz
    ii = np.concatenate([Qu.row, Qu.col]).astype(np.int64)
    jj = np.concatenate([Qu.col, Qu.row]).astype(np.int64)
    ee = np.concatenate([np.arange(E), np.arange(E)]).astype(np.int64)

    bi, bj = ii // Br, jj // Bc
    blk_id = bi * Kbc + bj
    uniq = np.unique(blk_id)
    ubr, ubc = uniq // Kbc, uniq % Kbc
    counts = np.bincount(ubr, minlength=Kbr)
    maxblkQ = max(int(counts.max(initial=0)), 1)
    q_bcols = np.zeros((Kbr, maxblkQ), np.int32)
    starts = np.zeros(Kbr + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(ubr, kind="stable")
    slots_of_uniq = np.empty(uniq.size, np.int64)
    slots_of_uniq[order] = np.arange(uniq.size) - starts[ubr[order]]
    q_bcols[ubr, slots_of_uniq] = ubc

    slot_of_edge = slots_of_uniq[np.searchsorted(uniq, blk_id)]
    q_pos = (((bi * Br + ii % Br) * maxblkQ + slot_of_edge) * Bc
             + jj % Bc).astype(np.int32)

    s_flat = st_flat = None
    if flat_group:
        s_flat = bsr_flat_from_csr(St, block=(Br, Bc), group=flat_group,
                                   pad_rows_to=nr, dtype=dtype)
        st_flat = bsr_flat_from_csr(StT, block=(Br, Bc), group=flat_group,
                                    pad_rows_to=nr, dtype=dtype)

    return BcsrOperands(
        s_blocks=s_blocks, st_blocks=st_blocks,
        g_src=torch.from_numpy(g_src), g_dst=torch.from_numpy(g_dst),
        w_edge=_cast_f32(w_edge, weights_dtype, "cpu"),
        s_pos=torch.from_numpy(s_pos), q_bcols=torch.from_numpy(q_bcols),
        q_pos=torch.from_numpy(q_pos),
        q_eidx=torch.from_numpy(ee.astype(np.int32)),
        s_flat=s_flat, st_flat=st_flat).to(device)


def from_jax_arrays(arrays: Mapping) -> BcsrOperands:
    """BcsrOperands (on the CPU) from the fields of a JAX
    ``sig_sdp_mmw_tpu.ops.bcsr.BcsrOperands`` given as numpy arrays: a
    mapping of field name to array, with ``s_blocks``/``st_blocks`` as
    mappings of (bcols, blocks, nrows) and ``s_flat``/``st_flat`` as
    mappings of (brows, bcols, blocks, nrows), or None."""

    def bell(m):
        if m is None:
            return None
        return BlockEll(bcols=as_tensor(m["bcols"]),
                        blocks=as_tensor(m["blocks"]), nrows=int(m["nrows"]))

    def flat(m):
        if m is None:
            return None
        return flat_bsr(np.asarray(m["brows"]), np.asarray(m["bcols"]),
                        as_tensor(m["blocks"]), int(m["nrows"]))

    return BcsrOperands(
        s_blocks=bell(arrays["s_blocks"]),
        st_blocks=bell(arrays.get("st_blocks")),
        **{k: as_tensor(arrays[k]) for k in ("g_src", "g_dst", "w_edge",
                                             "s_pos", "q_bcols", "q_pos",
                                             "q_eidx")},
        s_flat=flat(arrays.get("s_flat")), st_flat=flat(arrays.get("st_flat")))


def spatial_order(sta_locs: np.ndarray, cell_edge: float) -> np.ndarray:
    """Permutation sorting users by grid cell (row-major).  Superseded by
    :func:`hilbert_order`, which keeps neighbours close in both axes."""
    cx = np.floor(sta_locs[:, 0] / cell_edge).astype(np.int64)
    cy = np.floor(sta_locs[:, 1] / cell_edge).astype(np.int64)
    ncx = int(cx.max(initial=0)) + 1
    return np.argsort(cy * ncx + cx, kind="stable")


def hilbert_order(sta_locs: np.ndarray, order: int = 16) -> np.ndarray:
    """Permutation sorting users along a Hilbert space-filling curve, so an
    interference neighbourhood maps to a short index interval and the
    block-sparse storage gets denser blocks.  A pure relabeling.

    Vectorized d-index computation (the classic xy2d bit-interleave walk,
    one pass over ``order`` bit planes for all K points at once).
    """
    n = 1 << order
    xy = np.asarray(sta_locs, np.float64)
    ext = float((xy.max(axis=0) - xy.min(axis=0)).max())
    q = ((xy - xy.min(axis=0)) / max(ext, 1e-9) * (n - 1)).astype(np.int64)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(x.shape[0], np.int64)
    s = n // 2
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        flip = ry == 0
        xr = np.where(flip & (rx == 1), n - 1 - x, x)
        yr = np.where(flip & (rx == 1), n - 1 - y, y)
        x, y = np.where(flip, yr, xr), np.where(flip, xr, yr)
        s //= 2
    return np.argsort(d, kind="stable")
