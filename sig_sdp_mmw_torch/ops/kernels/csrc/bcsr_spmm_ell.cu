// Block-ELL SpMM for Hopper: out = A @ V, A stored as block-ELL (every
// block-row padded to the same slot count maxblk).
//
// Replaces the TPU kernel sig_sdp_mmw_tpu/ops/bcsr.py::bcsr_spmm_pallas
// (same operands, same contract: V is cast to the block dtype, products
// accumulate in float32; padding slots point at column-block 0 and hold
// zero values, so they need no masking).
//
// Operands (all device pointers, contiguous):
//   bcols   [Kbr, maxblk] int32 column-block id of each slot
//   blocks  [Kbr, BR, maxblk, 128] float32 or bfloat16, BR = 128 or 8
//   V       [Kbr*BR, D] float32, D a multiple of 8
//   out     [Kbr*BR, D] float32 (written in full, no prior zeroing needed)
//
// The TPU kernel walks a (Kbr, maxblk) grid in order and accumulates each
// (row, slot) product into the output row-block resident in VMEM.  On this
// card CTAs run in no order, so one CTA per (block-row, 64-column D tile)
// walks its row's maxblk slots itself and keeps the output tile in
// registers: no atomics, deterministic sums.  A block-row stored as
// [BR, maxblk*128] is one flat block-CSR step with G = maxblk, so the tile
// bodies are the flat kernel's (spmm_tile.cuh):
//   * 128-row bfloat16 blocks: tensor cores (WMMA m16n16k16, fp32 sums);
//   * 128-row float32 blocks and all 8-row blocks: fp32 FMA on the CUDA
//     cores (a bf16 x bf16-rounded product is exact in fp32, so this agrees
//     with the tensor-core path up to summation order).
// What bounds it: the stored block bytes (3.1 GB of bf16 per S-tilde apply
// at K = 1,009,200, a few percent of them nonzero) streamed once per D tile;
// the D tiles of a block-row are neighbours in the launch order, so the
// second tile reads the row's blocks from L2.  The grid is one-dimensional
// (block-row major), so 8-row blocks at a million links (126,150 block-rows)
// fit it.  Deliberately simple: no cp.async/TMA pipelining and no wgmma.

#include "spmm_tile.cuh"

namespace {

template <int BR, typename T>
__global__ void __launch_bounds__(spmm::Fma<BR>::NT)
bcsr_spmm_ell_fma(const int* __restrict__ bcols, const T* __restrict__ blocks,
                  const float* __restrict__ V, float* __restrict__ out,
                  int maxblk, int D, int ndt) {
  const int64_t r = blockIdx.x / ndt;
  const int d0 = (blockIdx.x % ndt) * spmm::DT;
  spmm::fma_tile<BR, T>(bcols, blocks, V, out, (int)r, (int)r + 1, maxblk, D,
                        r, d0);
}

__global__ void __launch_bounds__(spmm::WMMA_NT)
bcsr_spmm_ell_wmma(const int* __restrict__ bcols,
                   const __nv_bfloat16* __restrict__ blocks,
                   const float* __restrict__ V, float* __restrict__ out,
                   int maxblk, int D, int ndt) {
  const int64_t r = blockIdx.x / ndt;
  const int d0 = (blockIdx.x % ndt) * spmm::DT;
  spmm::wmma_tile_bf16(bcols, blocks, V, out, (int)r, (int)r + 1, maxblk, D,
                       r, d0);
}

}  // namespace

extern "C" {

// blk_dtype: 0 = float32 blocks, 1 = bfloat16 blocks; brow: 128 or 8.
// Returns the cudaError_t of the launch (0 = launched).
int bcsr_spmm_ell_launch(const void* bcols, const void* blocks, int blk_dtype,
                         int brow, const void* V, void* out, long long Kbr,
                         int maxblk, int D, void* stream) {
  if (Kbr <= 0 || maxblk <= 0 || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long ndt = (D + spmm::DT - 1) / spmm::DT;
  if (Kbr * ndt > 0x7fffffffLL || Kbr > 0x7fffffffLL / 128)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(Kbr * ndt));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* bc = static_cast<const int*>(bcols);
  const float* v = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  const int nd = (int)ndt;
  if (brow == 128 && blk_dtype == 1) {
    bcsr_spmm_ell_wmma<<<grid, spmm::WMMA_NT, 0, st>>>(
        bc, static_cast<const __nv_bfloat16*>(blocks), v, o, maxblk, D, nd);
  } else if (brow == 128 && blk_dtype == 0) {
    bcsr_spmm_ell_fma<128, float><<<grid, spmm::Fma<128>::NT, 0, st>>>(
        bc, static_cast<const float*>(blocks), v, o, maxblk, D, nd);
  } else if (brow == 8 && blk_dtype == 1) {
    bcsr_spmm_ell_fma<8, __nv_bfloat16><<<grid, spmm::Fma<8>::NT, 0, st>>>(
        bc, static_cast<const __nv_bfloat16*>(blocks), v, o, maxblk, D, nd);
  } else if (brow == 8 && blk_dtype == 0) {
    bcsr_spmm_ell_fma<8, float><<<grid, spmm::Fma<8>::NT, 0, st>>>(
        bc, static_cast<const float*>(blocks), v, o, maxblk, D, nd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
