"""Block-sparse operators of the large-graph MMW path, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.ops.bcsr`.  The interference graph, with users
in Hilbert-curve order (:func:`hilbert_order`), is banded, so it is stored as
dense 128x128 blocks of which only a few percent of entries are nonzero:

* :class:`BlockEll` — block-ELL, every block-row padded to the same slot
  count; its product is the hand-written CUDA kernel
  ``ops/kernels/csrc/bcsr_spmm_ell.cu`` behind :func:`bcsr_spmm`, with
  :func:`bcsr_spmm_reference` as its plain version; the transpose product
  and the pattern Grams are plain torch (:func:`bcsr_spmm_transpose`,
  :func:`bcsr_edge_gram_accum`, :func:`bcsr_block_gram`,
  :func:`bcsr_block_gram_accum`); :func:`bcsr_pair_from_state` builds S
  tilde and its transpose;
* :class:`FlatBsr` — flat block-CSR, only real blocks, grouped ``G`` per
  step; its products are the CUDA kernels ``bsr_spmm_flat.cu`` behind
  :func:`bsr_spmm_flat` and ``bsr_spmm_vres.cu`` (V resident in L2) behind
  :func:`bsr_spmm_vres`, both with :func:`bsr_spmm_flat_reference` as their
  plain version.

Each kernel wrapper takes the plain version for a CPU tensor and, for a CUDA
tensor, launches its kernel or raises; ``<wrapper>.launches`` counts its
launches, ``<wrapper>.route_launches`` them by the body they took
(:func:`spmm_route`'s name for it) and ``<wrapper>.generic_launches`` those
through a body of the shapes without a 128x128 fast path.  The host packers are
numpy (above ``_NATIVE_PACK_MIN_NNZ`` nonzeros, the shared C++ packer) and
give the JAX package's arrays exactly; the containers hold tensors and move
with ``.to(device)``.
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
    Bcol] so that (maxblk, Bcol) flattens into one contraction axis.

    ``nrows`` (= Kbr * Brow) counts the rows the operand holds, ``ncols``
    the rows of the V it multiplies (default ``nrows``, a square operand;
    a row shard, :func:`shard_rows`, keeps the full column count)."""

    bcols: torch.Tensor    # [Kbr, maxblk] int32 — column-block indices
    blocks: torch.Tensor   # [Kbr, Brow, maxblk, Bcol] — dense block values
    nrows: int
    ncols: Optional[int] = None

    def __post_init__(self):
        if self.ncols is None:
            object.__setattr__(self, "ncols", self.nrows)

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
    Kbc = mat.ncols // Bc
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
    can).  Every block shape has a kernel (:func:`bcsr_spmm`), which pads
    V's columns to a multiple of 8 first."""
    if mat.blocks.dtype not in _KERNEL_BLOCK_DTYPES:
        return f"blocks must be float32 or bfloat16, got {mat.blocks.dtype}"
    if (mat.blocks.dim() != 4 or mat.blocks.shape[0] != mat.Kb
            or mat.blocks.shape[2] != mat.bcols.shape[1]
            or mat.nrows != mat.Kb * mat.Brow or mat.ncols % mat.B):
        return (f"blocks {list(mat.blocks.shape)} do not match bcols "
                f"{list(mat.bcols.shape)}, nrows {mat.nrows} and ncols "
                f"{mat.ncols}")
    if V.dtype != torch.float32 and not (
            V.dtype == mat.blocks.dtype == torch.bfloat16):
        return (f"V must be float32 (or bfloat16 with bfloat16 blocks), got "
                f"{V.dtype}")
    if V.dim() != 2 or V.shape[0] != mat.ncols:
        return f"V must be [{mat.ncols}, D], got {list(V.shape)}"
    if V.shape[1] == 0 or V.shape[1] % 8:
        return f"D must be a positive multiple of 8, got {V.shape[1]}"
    if mat.bcols.dtype != torch.int32:
        return f"bcols must be torch.int32, got {mat.bcols.dtype}"
    if mat.bcols.numel() > _MAX_SLOTS:
        return f"{mat.bcols.numel()} block slots (at most {_MAX_SLOTS})"
    for name, t in (("blocks", mat.blocks), ("bcols", mat.bcols), ("V", V)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.device != V.device:
            return f"{name} is on {t.device}, V on {V.device}"
        if t.data_ptr() % 16:
            return f"{name} must be 16-byte aligned"
    return None


def bcsr_spmm(mat: BlockEll, V: torch.Tensor,
              row_chunk: Optional[int] = None,
              tile_cols: Optional[int] = None) -> torch.Tensor:
    """BlockEll [nrows, ncols] x [ncols, D] -> [nrows, D].  A CPU tensor
    goes to the plain version (``row_chunk`` bounds its transients); a CUDA
    tensor
    launches the block-ELL kernel on the current stream, which needs no
    chunking, or raises.  V's columns are padded with zeros to a multiple of
    8 for the kernel (the gap Lanczos sends D=1) and the result is sliced
    back.  ``bcsr_spmm.launches`` counts kernel launches,
    ``bcsr_spmm.route_launches`` them by route and
    ``bcsr_spmm.generic_launches`` those of them on a route of
    ``GENERIC_ROUTES``.

    The body follows :func:`spmm_route`.  128x128 blocks take the
    tensor-core ring tile, every other shape (8x128 included) the
    short-block tensor-core tile, in bfloat16 or float32 (three tf32
    products per pair, :func:`tf32_split_matmul`).  For bfloat16 blocks V
    is rounded to bfloat16 here, once per call (the plain version's cast),
    unless it comes in bfloat16 (the Lanczos steps write their operands so);
    float32 blocks read V as it is.  A CTA (ring) or warp (short) covers
    ``tile_cols`` output columns (default :func:`ring_tile_cols` and
    :func:`short_tile_cols`; the override applies to the ring tile only).
    Both tiles skip padding slots: they rely on the packers' layout, where
    a row's real blocks come first and every later slot at column-block 0
    holds zeros (``tests/test_torch_padding.py`` holds every packer to it).
    """
    if V.device.type == "cpu":
        return bcsr_spmm_reference(mat, V, row_chunk)
    if V.device.type != "cuda":
        raise ValueError(f"bcsr_spmm: no kernel for device {V.device}")
    D = V.shape[1] if V.dim() == 2 else 0
    Vk = pad_columns(V)
    why = ell_kernel_unsupported(mat, Vk)
    if why is not None:
        raise ValueError(f"bcsr_spmm: {why}")
    from sig_sdp_mmw_torch.ops.kernels import bcsr_spmm_ell_library

    lib = bcsr_spmm_ell_library()
    D8 = Vk.shape[1]
    out = torch.empty((mat.nrows, D8), dtype=torch.float32, device=V.device)
    stream = torch.cuda.current_stream(V.device).cuda_stream
    route = spmm_route("ell", mat.Brow, mat.B, mat.blocks.dtype)
    maxblk = mat.bcols.shape[1]
    with torch.cuda.device(V.device):
        if route == "ring":
            cols, Vb = ring_operand(Vk, tile_cols)
            rc = lib.bcsr_spmm_ell_bf16_launch(
                mat.bcols.data_ptr(), mat.blocks.data_ptr(), Vb.data_ptr(),
                Vb.shape[1], out.data_ptr(), mat.Kb, maxblk, D8, cols, stream)
        elif route == "ring_f32":
            rc = lib.bcsr_spmm_ell_ring_f32_launch(
                mat.bcols.data_ptr(), mat.blocks.data_ptr(), Vk.data_ptr(),
                out.data_ptr(), mat.Kb, maxblk, D8,
                ring_cols(D8, tile_cols), stream)
        elif route == "short_bf16":
            cols, Vb = short_operand(Vk)
            rc = lib.bcsr_spmm_ell_short_launch(
                mat.bcols.data_ptr(), mat.blocks.data_ptr(), mat.Brow, mat.B,
                Vb.data_ptr(), Vb.shape[1], out.data_ptr(), mat.Kb, maxblk,
                D8, cols, stream)
        else:
            rc = lib.bcsr_spmm_ell_short_f32_launch(
                mat.bcols.data_ptr(), mat.blocks.data_ptr(), mat.Brow, mat.B,
                Vk.data_ptr(), out.data_ptr(), mat.Kb, maxblk, D8,
                short_tile_cols(D8), stream)
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm: launch failed with cudaError {rc}")
    bcsr_spmm.launches += 1
    bcsr_spmm.route_launches[route] = bcsr_spmm.route_launches.get(route, 0) + 1
    bcsr_spmm.generic_launches += route in GENERIC_ROUTES
    return out if D8 == D else out[:, :D]


bcsr_spmm.launches = bcsr_spmm.generic_launches = 0
bcsr_spmm.route_launches = {}


def bcsr_spmm_transpose(mat_bcols: torch.Tensor, blocks: torch.Tensor,
                        V: torch.Tensor, row_chunk: Optional[int] = None,
                        ncols: Optional[int] = None) -> torch.Tensor:
    """``A^T @ V`` with A in BlockEll form (bcols, blocks): every
    per-(row, slot) contribution ``blocks[k, :, s, :]^T @ Vr[k]`` from one
    batched product per chunk of ``row_chunk`` block-rows (None: one chunk),
    added into its output column block.  V has A's rows (Kbr * Br); the
    output has ``ncols`` rows (default Kbr * Br, a square A).  Plain torch
    on every device (the JAX package's is an XLA scatter-add, not a Pallas
    kernel).

    The sum is deterministic: each column block adds its contributions in
    (block-row, slot) order, the order of a sequential scatter-add, one at
    a time, so the result repeats bit for bit on the card as well.  Slots
    at column-block 0 after a row's first are the packers' zero padding
    (``tests/test_torch_padding.py``) and are left out, which changes no
    bit of the sum."""
    Kbr, maxblk = mat_bcols.shape
    Br, Bc = blocks.shape[1], blocks.shape[-1]
    nrows = Kbr * Br
    Kbc = (ncols or nrows) // Bc
    D = V.shape[1]
    acc = V.dtype
    Vr = V.to(blocks.dtype).to(acc).reshape(Kbr, Br, D)
    seg = torch.zeros((Kbc, Bc, D), dtype=acc, device=V.device)
    chunks = _row_chunks(Kbr, row_chunk)
    # A chunk's contributions go to rows [0, n) of c; row ``zero`` stays 0.
    zero = max(j - i for i, j in chunks) * maxblk
    c = torch.empty((zero + 1, Bc, D), dtype=acc, device=V.device)
    c[zero] = 0
    slot = torch.arange(maxblk, device=V.device)
    for i, j in chunks:
        n = (j - i) * maxblk
        torch.bmm(blocks[i:j].to(acc).reshape(j - i, Br, maxblk * Bc)
                  .transpose(1, 2), Vr[i:j],
                  out=c[:n].view(j - i, maxblk * Bc, D))
        # Each column block's contributions, in slot order, padded with the
        # zero row: column t's w-th is idx[t, w].  Padding slots go to a
        # column Kbc of their own, which is not summed.
        bc = mat_bcols[i:j].long()
        tgt = torch.where((bc == 0) & (slot > 0), Kbc, bc).reshape(-1)
        order = torch.argsort(tgt, stable=True)
        count = torch.bincount(tgt, minlength=Kbc + 1)
        start = torch.cumsum(count, 0) - count
        width, npad = torch.stack([count[:Kbc].max(),
                                   count[Kbc]]).tolist()
        real = order[:n - npad]         # the padding sorts last
        tgt = tgt[real]
        idx = torch.full((Kbc, width), zero, dtype=torch.long,
                         device=V.device)
        idx[tgt, torch.arange(n - npad, device=V.device) - start[tgt]] = real
        cols = torch.nonzero(count[:Kbc]).flatten()   # the chunk's columns
        idx = idx[cols]
        for w in range(width):
            # ``cols`` are distinct, so each element takes exactly one add.
            seg.index_add_(0, cols, torch.index_select(c, 0, idx[:, w]))
    return seg.reshape(Kbc * Bc, D)


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


def bcsr_block_gram(bcols: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
    """Pattern-restricted block Gram: for every (block-row k, slot s),
    ``Xb[k] @ Xb[bcols[k, s]]^T`` -> [Kb, maxblk, B, B], one batched product
    per slot in ``Xb``'s dtype (square-block layout only)."""
    Kb, B, _ = Xb.shape
    out = Xb.new_zeros((Kb, bcols.shape[1], B, B))
    for s in range(bcols.shape[1]):
        out[:, s] = torch.bmm(Xb, Xb[bcols[:, s]].transpose(1, 2))
    return out


def bcsr_block_gram_accum(bcols: torch.Tensor, Xb: torch.Tensor,
                          acc: torch.Tensor, scale) -> torch.Tensor:
    """``acc[k, s] += scale * Xb[k] @ Xb[bcols[k, s]]^T`` slot by slot, in
    ``acc``'s dtype; updates ``acc`` in place and returns it.  (Square-block
    layout; the solvers use :func:`bcsr_edge_gram_accum` or the flat Gram of
    ``models/mmw_ell.py``.)"""
    X = Xb.to(acc.dtype)
    for s in range(bcols.shape[1]):
        acc[:, s] += scale * torch.bmm(X, X[bcols[:, s]].transpose(1, 2))
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
    nrows: int             # rows held (Kbr * Br)
    ncols: Optional[int] = None   # rows of V (default nrows, as BlockEll)

    def __post_init__(self):
        if self.ncols is None:
            object.__setattr__(self, "ncols", self.nrows)

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
             nrows: int, ncols: Optional[int] = None) -> FlatBsr:
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
                   nrows=int(nrows), ncols=ncols)


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
    Vb = V.to(mat.blocks.dtype).to(acc).reshape(mat.ncols // Bc, Bc, D)
    R = Vb[mat.bcols].reshape(mat.nsteps, G * Bc, D)
    prod = torch.einsum("sik,skd->sid", mat.blocks.to(acc), R)
    out = torch.zeros((mat.nrows // Br, Br, D), dtype=acc, device=V.device)
    out.index_add_(0, mat.brows, prod)
    return out.reshape(mat.nrows, D)


_KERNEL_BLOCK_DTYPES = (torch.float32, torch.bfloat16)

# Block slots a kernel operand may hold: the kernels index slots in 32 bits.
_MAX_SLOTS = 2 ** 31 - 1

# Output columns one CTA of the bfloat16 ring tile may cover (the widths
# instantiated in ops/kernels/csrc/spmm_tile.cuh, SPMM_RING_COLS).
RING_TILE_COLS = (8, 16, 32, 48, 64, 96, 128)


def ring_tile_cols(D: int) -> int:
    """Columns per CTA of the ring tile for a D-column V (D a multiple of
    8): the narrowest instantiated width that covers all of D, so each
    block leaves device memory once per call; 128 above 128."""
    return next((c for c in RING_TILE_COLS if c >= D), RING_TILE_COLS[-1])


def ring_cols(D: int, tile_cols: Optional[int] = None) -> int:
    """Columns per CTA of the ring tile: ``tile_cols``, which must be one of
    ``RING_TILE_COLS``, or :func:`ring_tile_cols` of D."""
    if tile_cols is None:
        return ring_tile_cols(D)
    if int(tile_cols) not in RING_TILE_COLS:
        raise ValueError(f"tile_cols must be one of {RING_TILE_COLS}, "
                         f"got {tile_cols}")
    return int(tile_cols)


def ring_operand(V: torch.Tensor, tile_cols: Optional[int] = None
                 ) -> Tuple[int, torch.Tensor]:
    """(columns per CTA, V rounded to bfloat16) for the bfloat16 ring tile.
    The rounding is the plain version's cast (round to nearest even), so
    every product is the same; columns past D up to a whole number of tiles
    are zero.  ``tile_cols`` overrides :func:`ring_tile_cols`."""
    D = V.shape[1]
    cols = ring_cols(D, tile_cols)
    ldv = -(-D // cols) * cols
    if ldv == D:
        return cols, V.to(torch.bfloat16)
    Vb = torch.zeros((V.shape[0], ldv), dtype=torch.bfloat16, device=V.device)
    Vb[:, :D] = V
    return cols, Vb


# Output columns one warp of the short-block tile may cover (the widths
# instantiated in ops/kernels/csrc/spmm_tile.cuh, SPMM_SHORT_COLS): whole
# m16 tiles of the transposed product.
SHORT_TILE_COLS = (16, 32, 48, 64, 96, 128)

# The routes of the shapes without a 128x128 fast path (counted by the
# wrappers' ``generic_launches``).
GENERIC_ROUTES = ("short_bf16", "short_f32")


def spmm_route(kind: str, Br: int, Bc: int, dtype) -> str:
    """The kernel body that takes a ``kind`` ("flat", "ell" or "vres")
    product of ``dtype`` blocks of ``Br`` x ``Bc``:

    * ``"ring"``: 128x128 bfloat16 blocks (the cp.async ring tile of the
      flat and block-ELL kernels, the TMA/wgmma ring of the V-resident one);
    * ``"ring_f32"``: 128x128 float32 blocks on the flat and block-ELL
      kernels (the ring tile, three tf32 products per pair);
    * ``"tma_f32"``: 128x128 float32 blocks on the V-resident kernel (its
      TMA ring, three tf32 products per pair on wgmma);
    * ``"short_bf16"``, ``"short_f32"``: blocks of every other shape (the
      short-block tensor-core tile; float32 as three tf32 products).
    """
    if kind not in ("flat", "ell", "vres"):
        raise ValueError(f"spmm_route: unknown kernel kind {kind!r}")
    if dtype not in _KERNEL_BLOCK_DTYPES:
        raise ValueError(f"spmm_route: no kernel for {dtype} blocks")
    bf16 = dtype == torch.bfloat16
    if (Br, Bc) == (128, 128):
        return "ring" if bf16 else "tma_f32" if kind == "vres" else "ring_f32"
    return "short_bf16" if bf16 else "short_f32"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 explicit mantissa bits, ties away from zero,
    so the low 13 bits of the result are zero; non-finite values pass
    through.  The float32 tiles round every finite value so, with the same
    integer operations.  With :func:`tf32_split_matmul`, the tests' model
    of the kernels' arithmetic (no path of the port calls it)."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # Adding half of the dropped part to the magnitude bits rounds a tie
    # away from zero; a carry moves into the exponent as it should.
    up = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), up, x)


def tf32_split_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` of float32 operands as the float32 tiles take it (3xTF32):
    each operand split as hi = tf32(x), lo = tf32(x - hi)
    (:func:`tf32_round`), the product A_lo @ B_hi + A_hi @ B_lo + A_hi @
    B_hi; A_lo @ B_lo is dropped.  Sums in float32 (the kernels start each
    8-deep step's three products from zero and add them to float32 sums)."""
    Ah, Bh = tf32_round(A), tf32_round(B)
    Al, Bl = tf32_round(A - Ah), tf32_round(B - Bh)
    return (Al @ Bh + Ah @ Bl) + Ah @ Bh


def short_tile_cols(D: int) -> int:
    """Columns per warp of the short-block tile for a D-column V (D a
    multiple of 8): the narrowest instantiated width that covers all of D,
    so each block is read once per call; 128 above 128."""
    return next((c for c in SHORT_TILE_COLS if c >= D), SHORT_TILE_COLS[-1])


def short_operand(V: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """(columns per warp, V rounded to bfloat16) for the short-block tile:
    :func:`ring_operand` at :func:`short_tile_cols` (the plain version's
    round to nearest even, zero columns up to a whole number of tiles)."""
    return ring_operand(V, short_tile_cols(V.shape[1]))


def pad_columns(V: torch.Tensor) -> torch.Tensor:
    """V (contiguous) with zero columns appended up to a multiple of 8: the
    kernels take D a multiple of 8, their wrappers any D (the gap Lanczos
    sends D=1), and slice the product back."""
    D = V.shape[1] if V.dim() == 2 else 0
    return F.pad(V, (0, -D % 8)) if D % 8 else V.contiguous()


def flat_kernel_unsupported(mat: FlatBsr, V: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernels cannot take these operands (None if they can).
    Every block shape has a kernel body (:func:`spmm_route`).  The wrappers pad V's columns to a multiple of 8 first
    (:func:`pad_columns`)."""
    if mat.blocks.dtype not in _KERNEL_BLOCK_DTYPES:
        return f"blocks must be float32 or bfloat16, got {mat.blocks.dtype}"
    if mat.nrows != mat.Kbr * mat.Br or mat.ncols % mat.Bc:
        return (f"nrows {mat.nrows} and ncols {mat.ncols} do not match "
                f"{mat.Kbr} block-rows of {mat.Br}x{mat.Bc} blocks")
    if V.dtype != torch.float32 and not (
            V.dtype == mat.blocks.dtype == torch.bfloat16):
        return (f"V must be float32 (or bfloat16 with bfloat16 blocks), got "
                f"{V.dtype}")
    if V.dim() != 2 or V.shape[0] != mat.ncols:
        return f"V must be [{mat.ncols}, D], got {list(V.shape)}"
    if V.shape[1] == 0 or V.shape[1] % 8:
        return f"D must be a positive multiple of 8, got {V.shape[1]}"
    for name, t, dt in (("row_ptr", mat.row_ptr, torch.int32),
                        ("bcols", mat.bcols, torch.int32)):
        if t.dtype != dt:
            return f"{name} must be {dt}, got {t.dtype}"
    if mat.bcols.numel() > _MAX_SLOTS:
        return f"{mat.bcols.numel()} block slots (at most {_MAX_SLOTS})"
    for name, t in (("blocks", mat.blocks), ("bcols", mat.bcols),
                    ("row_ptr", mat.row_ptr), ("V", V)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.device != V.device:
            return f"{name} is on {t.device}, V on {V.device}"
        if t.data_ptr() % 16:
            return f"{name} must be 16-byte aligned"
    return None


def bsr_spmm_flat(mat: FlatBsr, V: torch.Tensor,
                  tile_cols: Optional[int] = None) -> torch.Tensor:
    """``A @ V`` on flat block-CSR.  A CPU tensor goes to the plain version;
    a CUDA tensor launches the kernel on the current stream, or raises.
    Any D: V's columns are padded with zeros to a multiple of 8 for the
    kernel (:func:`pad_columns`) and the result is sliced back.
    ``bsr_spmm_flat.launches`` counts kernel launches,
    ``bsr_spmm_flat.route_launches`` them by route and
    ``bsr_spmm_flat.generic_launches`` those of them on a route of
    ``GENERIC_ROUTES``.

    The body follows :func:`spmm_route`, as in :func:`bcsr_spmm`: 128x128
    blocks take the tensor-core ring tile (``tile_cols`` output columns per
    CTA, default :func:`ring_tile_cols`), every other shape the short-block
    tensor-core tile, in bfloat16 (V rounded to bfloat16 here once, unless
    it comes in bfloat16) or float32 (three tf32 products per pair).  Both
    skip the slots that pad a row to a multiple of G (column-block 0 after
    the row's first slot, all zeros)."""
    if V.device.type == "cpu":
        return bsr_spmm_flat_reference(mat, V)
    if V.device.type != "cuda":
        raise ValueError(f"bsr_spmm_flat: no kernel for device {V.device}")
    Vk = pad_columns(V)
    why = flat_kernel_unsupported(mat, Vk)
    if why is not None:
        raise ValueError(f"bsr_spmm_flat: {why}")
    from sig_sdp_mmw_torch.ops.kernels import bsr_spmm_flat_library

    lib = bsr_spmm_flat_library()
    D8 = Vk.shape[1]
    out = torch.empty((mat.nrows, D8), dtype=torch.float32, device=V.device)
    stream = torch.cuda.current_stream(V.device).cuda_stream
    route = spmm_route("flat", mat.Br, mat.Bc, mat.blocks.dtype)
    ptrs = (mat.row_ptr.data_ptr(), mat.bcols.data_ptr(),
            mat.blocks.data_ptr())
    with torch.cuda.device(V.device):
        if route == "ring":
            cols, Vb = ring_operand(Vk, tile_cols)
            rc = lib.bsr_spmm_flat_bf16_launch(
                *ptrs, Vb.data_ptr(), Vb.shape[1], out.data_ptr(), mat.Kbr,
                mat.G, D8, cols, stream)
        elif route == "ring_f32":
            rc = lib.bsr_spmm_flat_ring_f32_launch(
                *ptrs, Vk.data_ptr(), out.data_ptr(), mat.Kbr, mat.G, D8,
                ring_cols(D8, tile_cols), stream)
        elif route == "short_bf16":
            cols, Vb = short_operand(Vk)
            rc = lib.bsr_spmm_flat_short_launch(
                *ptrs, mat.Br, mat.Bc, Vb.data_ptr(), Vb.shape[1],
                out.data_ptr(), mat.Kbr, mat.G, D8, cols, stream)
        else:
            rc = lib.bsr_spmm_flat_short_f32_launch(
                *ptrs, mat.Br, mat.Bc, Vk.data_ptr(), out.data_ptr(), mat.Kbr,
                mat.G, D8, short_tile_cols(D8), stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm_flat: launch failed with cudaError {rc}")
    bsr_spmm_flat.launches += 1
    bsr_spmm_flat.route_launches[route] = bsr_spmm_flat.route_launches.get(route, 0) + 1
    bsr_spmm_flat.generic_launches += route in GENERIC_ROUTES
    return out if D8 == V.shape[1] else out[:, :V.shape[1]]


bsr_spmm_flat.launches = bsr_spmm_flat.generic_launches = 0
bsr_spmm_flat.route_launches = {}


def vres_operand(V: torch.Tensor) -> torch.Tensor:
    """V (D a multiple of 8) rounded to bfloat16 for the V-resident kernel,
    the plain version's cast: [nrows, ldv] with ldv = D up to 128 (the
    kernel's loads fill the rest of a tile with zeros) and a multiple of 128
    above, the columns past D zero."""
    D = V.shape[1]
    ldv = D if D <= 128 else -(-D // 128) * 128
    if ldv == D:
        return V.to(torch.bfloat16)
    Vb = torch.zeros((V.shape[0], ldv), dtype=torch.bfloat16, device=V.device)
    Vb[:, :D] = V
    return Vb


def bsr_spmm_vres(mat: FlatBsr, V: torch.Tensor) -> torch.Tensor:
    """``A @ V`` on flat block-CSR with V resident in L2 (the Hopper form of
    the TPU kernel's VMEM-resident V, see ``bsr_spmm_vres.cu``).  Same
    contract and plain version as :func:`bsr_spmm_flat`, any D (padded to a
    multiple of 8 and sliced back).  On CUDA, V is cast to the block dtype
    once here (:func:`vres_operand` for bfloat16 blocks; float32 blocks
    read the caller's V), and that copy is what the kernel keeps in L2; both
    dtypes run on persistent CTAs that take the block-rows in index order
    from a counter zeroed on the stream before each launch, float32 as three
    tf32 products per pair (``"tma_f32"``).  Block shapes other than
    128x128 go through the flat kernel's short-block tile (bfloat16 or
    float32), built into this kernel's library, with no residency hint
    (:func:`spmm_route`).
    ``bsr_spmm_vres.launches`` counts kernel launches,
    ``bsr_spmm_vres.route_launches`` them by route and
    ``bsr_spmm_vres.generic_launches`` those of them on a route of
    ``GENERIC_ROUTES``."""
    if V.device.type == "cpu":
        return bsr_spmm_flat_reference(mat, V)
    if V.device.type != "cuda":
        raise ValueError(f"bsr_spmm_vres: no kernel for device {V.device}")
    Vk = pad_columns(V)
    why = flat_kernel_unsupported(mat, Vk)
    if why is None and mat.ncols != mat.nrows:
        # Its TMA map spans V as [Kbr * 128] rows.
        why = (f"square operands only (nrows {mat.nrows}, ncols "
               f"{mat.ncols})")
    if why is not None:
        raise ValueError(f"bsr_spmm_vres: {why}")
    from sig_sdp_mmw_torch.ops.kernels import bsr_spmm_vres_library

    lib = bsr_spmm_vres_library()
    D8 = Vk.shape[1]
    out = torch.empty((mat.nrows, D8), dtype=torch.float32, device=V.device)
    stream = torch.cuda.current_stream(V.device).cuda_stream
    route = spmm_route("vres", mat.Br, mat.Bc, mat.blocks.dtype)
    ptrs = (mat.row_ptr.data_ptr(), mat.bcols.data_ptr(),
            mat.blocks.data_ptr())
    with torch.cuda.device(V.device):
        if route == "ring":
            Vc = vres_operand(Vk)
            counter = torch.empty((1,), dtype=torch.int32, device=V.device)
            rc = lib.bsr_spmm_vres_bf16_launch(
                *ptrs, Vc.data_ptr(), Vc.shape[1], counter.data_ptr(),
                out.data_ptr(), mat.Kbr, mat.nsteps, mat.G, D8, stream)
        elif route == "short_bf16":
            cols, Vb = short_operand(Vk)
            rc = lib.bsr_spmm_vres_short_launch(
                *ptrs, mat.Br, mat.Bc, Vb.data_ptr(), Vb.shape[1],
                out.data_ptr(), mat.Kbr, mat.G, D8, cols, stream)
        elif route == "tma_f32":
            counter = torch.empty((1,), dtype=torch.int32, device=V.device)
            rc = lib.bsr_spmm_vres_f32_launch(
                *ptrs, Vk.data_ptr(), counter.data_ptr(), out.data_ptr(),
                mat.Kbr, mat.nsteps, mat.G, D8, stream)
        else:
            rc = lib.bsr_spmm_vres_short_f32_launch(
                *ptrs, mat.Br, mat.Bc, Vk.data_ptr(), out.data_ptr(), mat.Kbr,
                mat.G, D8, short_tile_cols(D8), stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm_vres: launch failed with cudaError {rc}")
    bsr_spmm_vres.launches += 1
    bsr_spmm_vres.route_launches[route] = bsr_spmm_vres.route_launches.get(route, 0) + 1
    bsr_spmm_vres.generic_launches += route in GENERIC_ROUTES
    return out if D8 == V.shape[1] else out[:, :V.shape[1]]


bsr_spmm_vres.launches = bsr_spmm_vres.generic_launches = 0
bsr_spmm_vres.route_launches = {}


def bcsr_pair_from_state(S_csr, Q_csr, block: int = 128,
                         dtype=torch.float32, device="cuda"
                         ) -> Tuple[BlockEll, BlockEll]:
    """(S tilde, S tilde^T) as BlockEll matrices, rows padded to a multiple
    of ``block``: built on the host as :func:`bcsr_from_csr` builds, then
    moved to ``device`` once.  Both feed :func:`bcsr_spmm` unchanged."""
    from sig_sdp_mmw_torch.core.ell import build_st_csr

    St = build_st_csr(S_csr, Q_csr)
    K = St.shape[0]
    nr = ((K + block - 1) // block) * block
    StT = St.transpose().tocsr()
    return (bcsr_from_csr(St, block=block, pad_rows_to=nr, dtype=dtype,
                          device=device),
            bcsr_from_csr(StT, block=block, pad_rows_to=nr, dtype=dtype,
                          device=device))


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


def _gram_maps_np(ebr, eslot, erloc, ecloc, maxblk: int, Br: int, Bc: int):
    """The edge-level Gram maps ``(g_src, g_dst)`` [maxblk, max_e] int32 of
    the numpy build from the entry maps of ``_bcsr_arrays_np`` (entry order
    = the CSR's sorted order; ``g_dst`` points unused places at the sink
    ``nnz``)."""
    nnz = eslot.size
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
    return g_src, g_dst


def _sym_weights_np(St) -> np.ndarray:
    """Symmetrization weights (1 one-way, 0.5 bidirectional) float32 [nnz],
    aligned with the sorted CSR ``St``'s entry order."""
    P = St.copy()
    P.data = np.ones_like(P.data)
    B2 = P.multiply(P.transpose()).tocsr()
    Wm = (P - 0.5 * B2).tocsr()
    Wm.sort_indices()
    if not (np.array_equal(Wm.indices, St.indices)
            and np.array_equal(Wm.indptr, St.indptr)):
        raise AssertionError("weight/value edge orders diverged")
    return Wm.data.astype(np.float32)


def _q_layout_np(Q_csr, Br: int, Bc: int, nr: int):
    """The association edges' block layout on ``nr`` padded rows:
    ``(q_bcols [Kbr, maxblkQ], q_pos [2E], q_eidx [2E])`` int32 (the
    blocks that hold an edge, each edge's flat position in them, and its
    index in the upper-triangle edge order)."""
    import scipy.sparse

    Kbr, Kbc = nr // Br, nr // Bc
    Qu = scipy.sparse.triu(Q_csr.tocsr(), k=1).tocoo()
    E = Qu.nnz
    ii = np.concatenate([Qu.row, Qu.col]).astype(np.int64)
    jj = np.concatenate([Qu.col, Qu.row]).astype(np.int64)
    ee = np.concatenate([np.arange(E), np.arange(E)]).astype(np.int32)

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
    return q_bcols, q_pos, ee


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
    StT = St.transpose().tocsr()
    if St.nnz > _NATIVE_PACK_MIN_NNZ and dtype in _KERNEL_BLOCK_DTYPES:
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
        g_src, g_dst = _gram_maps_np(ebr, eslot, erloc, ecloc, maxblk, Br,
                                     Bc)
        s_pos = (((ebr * Br + erloc) * maxblk + eslot) * Bc
                 + ecloc).astype(np.int32)
        w_edge = _sym_weights_np(St)

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

    q_bcols, q_pos, ee = _q_layout_np(Q_csr, Br, Bc, nr)

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
        q_eidx=torch.from_numpy(ee),
        s_flat=s_flat, st_flat=st_flat).to(device)


def shard_range(n: int, g: int, size: int) -> Tuple[int, int]:
    """[r0, r1): part ``g`` of ``size`` of ``n`` units (block-rows, rows),
    contiguous, ``ceil(n / size)`` each and the rest in the last part.
    Raises when a part would be empty."""
    chunk = -(-n // size)
    r0, r1 = g * chunk, min((g + 1) * chunk, n)
    if not 0 <= g < size or r0 >= r1:
        raise ValueError(f"cannot split {n} rows into {size} non-empty "
                         f"parts of {chunk} (part {g})")
    return r0, r1


def shard_rows(op, g: int, n: int):
    """Rank ``g`` of ``n``'s row shard of a block operand: block-rows
    [r0, r1) of :func:`shard_range`, column indices and ``ncols`` kept
    global, so the shard's product is rows [r0*Br, r1*Br) of the full one.
    The shard owns its memory (a copy, not a view of the full operand).

    * :class:`BlockEll`: its bcols and blocks rows;
    * :class:`FlatBsr`: the contiguous steps of those block-rows, ``brows``
      and ``row_ptr`` rebased to the shard;
    * :class:`BcsrOperands`: every block operand as above; the association
      layout (``q_pos``/``q_eidx``) and the Gram maps (``g_src``/``g_dst``,
      ``s_pos``, ``w_edge``) keep the entries of the shard's rows, positions
      rebased to the shard's blocks and S̃ edges renumbered from the
      shard's first (edges are in row order, so a shard's are contiguous);
      association edge ids stay global.
    """
    if isinstance(op, BlockEll):
        r0, r1 = shard_range(op.Kb, g, n)
        return BlockEll(bcols=op.bcols[r0:r1].clone(),
                        blocks=op.blocks[r0:r1].clone(),
                        nrows=(r1 - r0) * op.Brow, ncols=op.ncols)
    if isinstance(op, FlatBsr):
        r0, r1 = shard_range(op.Kbr, g, n)
        s0, s1 = (int(x) for x in op.row_ptr[[r0, r1]].tolist())
        return FlatBsr(brows=op.brows[s0:s1] - r0,
                       bcols=op.bcols[s0 * op.G:s1 * op.G].clone(),
                       blocks=op.blocks[s0:s1].clone(),
                       row_ptr=op.row_ptr[r0:r1 + 1] - s0,
                       nrows=(r1 - r0) * op.Br, ncols=op.ncols)
    if not isinstance(op, BcsrOperands):
        raise TypeError(f"shard_rows: no row shard of {type(op).__name__}")
    sb = op.s_blocks
    r0, r1 = shard_range(sb.Kb, g, n)
    Br, Bc, maxblk = sb.Brow, sb.B, sb.bcols.shape[1]
    dev = op.w_edge.device
    # S̃ edges of the shard: contiguous, in block-row order.
    s_pos = op.s_pos.cpu().numpy().astype(np.int64)
    e0, e1 = np.searchsorted(s_pos // (Br * maxblk * Bc), [r0, r1])
    nnz_loc = int(e1 - e0)
    src = op.g_src.cpu().numpy().astype(np.int64)
    dst = op.g_dst.cpu().numpy().astype(np.int64)
    keep = (dst >= e0) & (dst < e1)
    max_e = max(int(keep.sum(1).max(initial=0)), 1)
    g_src = np.zeros((maxblk, max_e), np.int32)
    g_dst = np.full((maxblk, max_e), nnz_loc, np.int32)
    for s in range(maxblk):
        k = keep[s]
        g_src[s, :k.sum()] = src[s, k] - r0 * Br * Bc
        g_dst[s, :k.sum()] = dst[s, k] - e0
    # Association entries in the shard's block-rows.
    maxblkQ = op.q_bcols.shape[1]
    q_row = Br * maxblkQ * Bc
    q_pos = op.q_pos.long()
    q_in = (q_pos >= r0 * q_row) & (q_pos < r1 * q_row)
    return dataclasses.replace(
        op, s_blocks=shard_rows(sb, g, n),
        st_blocks=(None if op.st_blocks is None
                   else shard_rows(op.st_blocks, g, n)),
        g_src=torch.from_numpy(g_src).to(dev),
        g_dst=torch.from_numpy(g_dst).to(dev),
        w_edge=op.w_edge[e0:e1].clone(),
        s_pos=(op.s_pos[e0:e1] - r0 * Br * maxblk * Bc).clone(),
        q_bcols=op.q_bcols[r0:r1].clone(),
        q_pos=(q_pos[q_in] - r0 * q_row).to(op.q_pos.dtype),
        q_eidx=op.q_eidx[q_in],
        s_flat=None if op.s_flat is None else shard_rows(op.s_flat, g, n),
        st_flat=None if op.st_flat is None else shard_rows(op.st_flat, g, n))


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
