// Flat block-CSR SpMM for Hopper: out = A @ V, A stored as only its real
// 128x128 blocks.
//
// Replaces the TPU kernel sig_sdp_mmw_tpu/ops/bcsr.py::bsr_spmm_pallas_flat
// (same operands, same contract: V is cast to the block dtype, products
// accumulate in float32, every output row-block is written exactly once).
//
// Operands (all device pointers, contiguous):
//   row_ptr [Kbr+1] int32  step offsets per block-row (steps of one block-row
//                          are consecutive, every row has at least one step)
//   bcols   [nsteps*G] int32 column-block id of each stored block
//   blocks  [nsteps, 128, G*128] float32 or bfloat16: G blocks side by side
//   V       [nrows, D] float32, D a multiple of 8
//   out     [nrows, D] float32 (written in full, no prior zeroing needed)
//
// What bounds it on this card: the bytes of the stored blocks.  The blocks
// are dense 128x128 tiles of an interference graph that fill only a few
// percent of each tile, so the kernel streams ~32 KB (bf16) of mostly zeros
// per block while V's column-blocks are reused by many block-rows and stay
// in the 50 MB L2.  The design keeps that stream to one pass per D tile:
//   * one CTA per (block-row, 64-column D tile); the CTA walks its row's
//     steps and their G blocks in order and keeps the [128, 64] output tile
//     in registers (tensor-core fragments for bf16), so there are no atomics,
//     no cross-CTA reduction and the result is deterministic;
//   * the D tiles of one block-row are neighbours in the launch order
//     (blockIdx.x), so they run together and the second tile finds the
//     row's blocks in L2 instead of streaming them again;
//   * the tile bodies (spmm_tile.cuh, shared with the block-ELL kernel)
//     stage each [128, 32] slice of a block and the matching [32, 64] slice
//     of V through shared memory once, with coalesced (16-byte for bf16)
//     reads; V is rounded to the block dtype as it is staged;
//   * bf16 blocks multiply on the tensor cores (WMMA m16n16k16, fp32
//     accumulate: each bf16 x bf16 product is exact in fp32, so this equals
//     the TPU kernel's preferred_element_type=float32 dot up to summation
//     order); float32 blocks use fp32 FMA on the CUDA cores, keeping full
//     float32 precision (no TF32).
// Deliberately simple: no cp.async/TMA pipelining and no wgmma yet.

#include "spmm_tile.cuh"

namespace {

__global__ void __launch_bounds__(spmm::Fma<128>::NT)
bsr_spmm_flat_f32(const int* __restrict__ row_ptr,
                  const int* __restrict__ bcols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ V, float* __restrict__ out,
                  int G, int D) {
  const int r = blockIdx.y;
  spmm::fma_tile<128, float>(bcols, blocks, V, out, row_ptr[r],
                             row_ptr[r + 1], G, D, r, blockIdx.x * spmm::DT);
}

__global__ void __launch_bounds__(spmm::WMMA_NT)
bsr_spmm_flat_bf16(const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols,
                   const __nv_bfloat16* __restrict__ blocks,
                   const float* __restrict__ V, float* __restrict__ out,
                   int G, int D) {
  const int r = blockIdx.y;
  spmm::wmma_tile_bf16(bcols, blocks, V, out, row_ptr[r], row_ptr[r + 1], G,
                       D, r, blockIdx.x * spmm::DT);
}

}  // namespace

extern "C" {

// blk_dtype: 0 = float32 blocks, 1 = bfloat16 blocks.  Returns the
// cudaError_t of the launch (0 = launched).
int bsr_spmm_flat_launch(const void* row_ptr, const void* bcols,
                         const void* blocks, int blk_dtype, const void* V,
                         void* out, int Kbr, int G, int D, void* stream) {
  if (Kbr <= 0 || Kbr > 65535 || G <= 0 || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((D + spmm::DT - 1) / spmm::DT, Kbr);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (blk_dtype == 0) {
    bsr_spmm_flat_f32<<<grid, spmm::Fma<128>::NT, 0, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
        static_cast<const float*>(blocks), static_cast<const float*>(V),
        static_cast<float*>(out), G, D);
  } else if (blk_dtype == 1) {
    bsr_spmm_flat_bf16<<<grid, spmm::WMMA_NT, 0, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
        static_cast<const __nv_bfloat16*>(blocks), static_cast<const float*>(V),
        static_cast<float*>(out), G, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
