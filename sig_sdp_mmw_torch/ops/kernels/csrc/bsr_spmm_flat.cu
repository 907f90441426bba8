// Flat block-CSR SpMM for Hopper: out = A @ V, A stored as only its real
// blocks (128x128 on the main path, any Br x Bc through the short-block
// and generic tiles).
//
// Replaces the TPU kernel sig_sdp_mmw_tpu/ops/bcsr.py::bsr_spmm_pallas_flat
// (same operands, same contract: V is cast to the block dtype, products
// accumulate in float32, every output row-block is written exactly once).
//
// Operands (all device pointers, contiguous):
//   row_ptr [Kbr+1] int32  step offsets per block-row (steps of one block-row
//                          are consecutive, every row has at least one step)
//   bcols   [nsteps*G] int32 column-block id of each stored block; a row's
//                          real blocks come first, then padding to a multiple
//                          of G at column-block 0
//   blocks  [nsteps, 128, G*128] float32 or bfloat16: G blocks side by side
//   V       [nrows, D] float32, D a multiple of 8 (float32 entry point), or
//   Vb      [nrows, ldv] bfloat16, rounded by the wrapper, zero past D
//           (bf16 entry point)
//   out     [nrows, D] float32 (written in full, no prior zeroing needed)
//
// What bounds it on this card: device-memory bytes.  The blocks are dense
// 128x128 tiles of an interference graph that fill only a few percent of
// each tile, so at K = 100,467 (G = 8) an S-tilde apply at D = 128 needs
// 0.192 GB of real bf16 blocks plus 0.10 GB of V and out, 0.088 ms at
// 3.35 TB/s, against 0.025 ms of tensor-core work.  The design:
//   * one CTA per (block-row, D tile) walks the row's steps and their G
//     blocks in order and keeps the output tile in registers: no atomics,
//     no cross-CTA reduction, a deterministic result;
//   * bf16 blocks go through ring_tile_bf16 (spmm_tile.cuh, shared with the
//     block-ELL kernel): the 23% of slots that pad rows to a multiple of G
//     are skipped, all of D up to 128 is one tile (each block leaves device
//     memory once), V is read as bfloat16 rounded once by the wrapper, and
//     2-3 slices of 16 KB of A per CTA stay in flight through a cp.async
//     ring feeding mma.sync bf16 (each bf16 x bf16 product is exact in fp32,
//     so this equals the TPU kernel's preferred_element_type=float32 dot up
//     to summation order);
//   * float32 blocks (off the main paths) use fp32 FMA on the CUDA cores,
//     64 columns per CTA, keeping full float32 precision (no TF32); the D
//     tiles of one block-row are neighbours in the launch order, so the
//     second tile finds the row's blocks in L2;
//   * every other block shape, Br x Bc at run time (the packers' default
//     8x128, the 32x32 blocks of the mid-K search, ...), goes in bfloat16
//     through the short-block tile of spmm_tile.cuh (one warp per block-row
//     or 8-32-row slice, mma.sync on the transposed tile, a per-warp
//     cp.async ring; bsr_spmm_flat_short_launch), in float32 through the
//     generic FMA tile (bsr_spmm_flat_generic_launch).
// Every grid is one-dimensional (block-row major, the D tiles of a row
// adjacent), so an operand may have more than 65,535 block-rows (the
// million-link S-tilde at 8-row blocks has 126,160).

#include "spmm_tile.cuh"

namespace {

__global__ void __launch_bounds__(spmm::Fma<128>::NT)
bsr_spmm_flat_f32(const int* __restrict__ row_ptr,
                  const int* __restrict__ bcols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ V, float* __restrict__ out,
                  int G, int D, int ndt) {
  const int64_t r = blockIdx.x / ndt;
  spmm::fma_tile<128>(bcols, blocks, V, out, row_ptr[r], row_ptr[r + 1], G,
                      D, r, (blockIdx.x % ndt) * spmm::DT);
}

template <int N>
__global__ void __launch_bounds__(spmm::ring::NT, 2)
bsr_spmm_flat_ring(const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols,
                   const __nv_bfloat16* __restrict__ blocks,
                   const __nv_bfloat16* __restrict__ Vb, int ldv,
                   float* __restrict__ out, int G, int D, int ndt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t r = blockIdx.x / ndt;
  spmm::ring_tile_bf16<N>(bcols, blocks, Vb, ldv, out,
                          (int64_t)row_ptr[r] * G, (int64_t)row_ptr[r + 1] * G,
                          G, D, r, (blockIdx.x % ndt) * N, smem);
}

template <int N>
int launch_ring(const int* row_ptr, const int* bcols,
                const __nv_bfloat16* blocks, const __nv_bfloat16* Vb, int ldv,
                float* out, int Kbr, int G, int D, cudaStream_t st) {
  const int ndt = (D + N - 1) / N;
  if (ldv < ndt * N || (long long)Kbr * ndt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = spmm::ring::Cfg<N>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bsr_spmm_flat_ring<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bsr_spmm_flat_ring<N><<<(unsigned)((long long)Kbr * ndt), spmm::ring::NT,
                          smem, st>>>(row_ptr, bcols, blocks, Vb, ldv, out, G,
                                      D, ndt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float32 blocks and float32 V.  Returns the cudaError_t of the launch (0 =
// launched).
int bsr_spmm_flat_launch(const void* row_ptr, const void* bcols,
                         const void* blocks, const void* V, void* out,
                         int Kbr, int G, int D, void* stream) {
  const int ndt = (D + spmm::DT - 1) / spmm::DT;
  if (Kbr <= 0 || G <= 0 || D <= 0 || D % 8 != 0 ||
      (long long)Kbr * ndt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bsr_spmm_flat_f32<<<(unsigned)((long long)Kbr * ndt), spmm::Fma<128>::NT, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
      static_cast<const float*>(blocks), static_cast<const float*>(V),
      static_cast<float*>(out), G, D, ndt);
  return (int)cudaGetLastError();
}

// Float32 blocks of any other shape (Br x Bc at run time) through the
// generic tile (spmm_tile.cuh): float32 V [nrows, D], D a multiple of 8;
// out [nrows, D] float32.  Returns the cudaError_t of the launch.
int bsr_spmm_flat_generic_launch(const void* row_ptr, const void* bcols,
                                 const void* blocks, int Br, int Bc,
                                 const void* V, void* out, int Kbr, int G,
                                 int D, void* stream) {
  return spmm::launch_flat_generic(row_ptr, bcols, blocks, Br, Bc, V, out,
                                   Kbr, G, D,
                                   reinterpret_cast<cudaStream_t>(stream));
}

// bfloat16 blocks of any shape but 128x128 (Br x Bc at run time) through
// the short-block tensor-core tile (spmm_tile.cuh): Vb [nrows, ldv] bf16,
// rounded by the wrapper, ncols output columns per warp (16, 32, 48, 64, 96
// or 128; ldv >= ceil(D / ncols) * ncols), out [nrows, D] float32.
// Returns the cudaError_t of the launch.
int bsr_spmm_flat_short_launch(const void* row_ptr, const void* bcols,
                               const void* blocks, int Br, int Bc,
                               const void* Vb, int ldv, void* out, int Kbr,
                               int G, int D, int ncols, void* stream) {
  return spmm::launch_short_bf16<false>(
      row_ptr, bcols, blocks, Br, Bc, Vb, ldv, out, Kbr, G, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

// bfloat16 blocks through the ring tile: Vb [nrows, ldv] bf16, ncols output
// columns per CTA (8, 16, 32, 48, 64, 96 or 128; ldv >= ceil(D / ncols) *
// ncols), out [nrows, D] float32.  Returns the cudaError_t of the launch.
int bsr_spmm_flat_bf16_launch(const void* row_ptr, const void* bcols,
                              const void* blocks, const void* Vb, int ldv,
                              void* out, int Kbr, int G, int D, int ncols,
                              void* stream) {
  if (Kbr <= 0 || G <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(blocks);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(Vb);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (ncols) {
#define SPMM_CASE(N) \
  case N:            \
    return launch_ring<N>(rp, bc, a, v, ldv, o, Kbr, G, D, st);
    SPMM_RING_COLS(SPMM_CASE)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
