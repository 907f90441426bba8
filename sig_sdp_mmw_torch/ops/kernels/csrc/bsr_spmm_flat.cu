// Flat block-CSR SpMM for Hopper: out = A @ V, A stored as only its real
// blocks (128x128 on the main path, any Br x Bc through the short-block
// tile).
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
//   blocks  [nsteps, Br, G*Bc] float32 or bfloat16: G blocks side by side
//   V       [nrows, D] float32, D a multiple of 8 (float32 entry points), or
//   Vb      [nrows, ldv] bfloat16, rounded by the wrapper, zero past D
//           (bf16 entry points)
//   out     [nrows, D] float32 (written in full, no prior zeroing needed)
//
// What bounds it on this card: device-memory bytes.  The blocks are dense
// 128x128 tiles of an interference graph that fill only a few percent of
// each tile, so at K = 100,467 (G = 8) an S-tilde apply at D = 128 needs
// 0.192 GB of real bf16 blocks plus 0.10 GB of V and out, 0.088 ms at
// 3.35 TB/s, against 0.025 ms of tensor-core work (float32 blocks: twice
// the block bytes, against 0.149 ms of split-tf32 work).  The design:
//   * one CTA per (block-row, D tile) walks the row's steps and their G
//     blocks in order and keeps the output tile in registers: no atomics,
//     no cross-CTA reduction, a deterministic result;
//   * 128x128 blocks go through ring_tile (spmm_tile.cuh, shared with the
//     block-ELL kernel): the 23% of slots that pad rows to a multiple of G
//     are skipped, all of D up to 128 is one tile (each block leaves device
//     memory once), and 2-5 slices of 16 KB of A per CTA stay in flight
//     through a cp.async ring feeding the tensor cores.  bfloat16 blocks
//     read V rounded once by the wrapper and run on mma.sync (each bf16 x
//     bf16 product is exact in fp32, so this equals the TPU kernel's
//     preferred_element_type=float32 dot up to summation order); float32
//     blocks read the caller's V and take three tf32 products per pair on
//     wgmma (3xTF32, float32 accuracy);
//   * every other block shape, Br x Bc at run time (the packers' default
//     8x128, the 32x32 blocks of the mid-K search, ...), goes through the
//     short-block tile of spmm_tile.cuh (one warp per block-row or 8-32-row
//     slice, mma.sync on the transposed tile, a per-warp cp.async ring), in
//     bfloat16 (bsr_spmm_flat_short_launch) or float32
//     (bsr_spmm_flat_short_f32_launch).
// Every grid is one-dimensional (block-row major, the D tiles of a row
// adjacent), so an operand may have more than 65,535 block-rows (the
// million-link S-tilde at 8-row blocks has 126,160).

#include "spmm_tile.cuh"

namespace {

template <typename T, int N>
__global__ void __launch_bounds__(spmm::ring::NT,
                                  spmm::RingLaunch<T, N>::CTAS)
bsr_spmm_flat_ring(const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols, const T* __restrict__ blocks,
                   const T* __restrict__ V, int ldv, float* __restrict__ out,
                   int G, int D, int ndt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t r = blockIdx.x / ndt;
  spmm::ring_tile<T, N>(bcols, blocks, V, ldv, out, (int64_t)row_ptr[r] * G,
                        (int64_t)row_ptr[r + 1] * G, G, D, r,
                        (blockIdx.x % ndt) * N, smem);
}

template <typename T, int N>
int launch_ring_n(const int* row_ptr, const int* bcols, const T* blocks,
                  const T* V, int ldv, float* out, int Kbr, int G, int D,
                  cudaStream_t st) {
  const int ndt = (D + N - 1) / N;
  if (!spmm::v_pitch_ok<T>(ldv, D, N) || (long long)Kbr * ndt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = spmm::RingLaunch<T, N>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bsr_spmm_flat_ring<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  bsr_spmm_flat_ring<T, N><<<(unsigned)((long long)Kbr * ndt),
                             spmm::ring::NT, smem, st>>>(
      row_ptr, bcols, blocks, V, ldv, out, G, D, ndt);
  return (int)cudaGetLastError();
}

// 128x128 blocks of dtype T through the ring tile, ncols output columns per
// CTA (one of SPMM_RING_COLS).
template <typename T>
int launch_ring(const void* row_ptr, const void* bcols, const void* blocks,
                const void* V, int ldv, void* out, int Kbr, int G, int D,
                int ncols, void* stream) {
  if (Kbr <= 0 || G <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const T* a = static_cast<const T*>(blocks);
  const T* v = static_cast<const T*>(V);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (ncols) {
#define SPMM_CASE(N) \
  case N:            \
    return launch_ring_n<T, N>(rp, bc, a, v, ldv, o, Kbr, G, D, st);
    SPMM_RING_COLS(SPMM_CASE)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bfloat16 blocks through the ring tile: Vb [nrows, ldv] bf16, ncols output
// columns per CTA (8, 16, 32, 48, 64, 96 or 128; ldv >= ceil(D / ncols) *
// ncols), out [nrows, D] float32.  Returns the cudaError_t of the launch (0
// = launched).
int bsr_spmm_flat_bf16_launch(const void* row_ptr, const void* bcols,
                              const void* blocks, const void* Vb, int ldv,
                              void* out, int Kbr, int G, int D, int ncols,
                              void* stream) {
  return launch_ring<__nv_bfloat16>(row_ptr, bcols, blocks, Vb, ldv, out, Kbr,
                                    G, D, ncols, stream);
}

// Float32 blocks through the ring tile (3xTF32): V [nrows, D] float32, ncols
// as above, out [nrows, D] float32.  Returns the cudaError_t of the launch.
int bsr_spmm_flat_ring_f32_launch(const void* row_ptr, const void* bcols,
                                  const void* blocks, const void* V,
                                  void* out, int Kbr, int G, int D, int ncols,
                                  void* stream) {
  return launch_ring<float>(row_ptr, bcols, blocks, V, D, out, Kbr, G, D,
                            ncols, stream);
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
  return spmm::launch_short<__nv_bfloat16, false>(
      row_ptr, bcols, blocks, Br, Bc, Vb, ldv, out, Kbr, G, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

// Float32 blocks of any shape but 128x128 through the short-block tile
// (3xTF32): V [nrows, D] float32, ncols as above, out [nrows, D] float32.
// Returns the cudaError_t of the launch.
int bsr_spmm_flat_short_f32_launch(const void* row_ptr, const void* bcols,
                                   const void* blocks, int Br, int Bc,
                                   const void* V, void* out, int Kbr, int G,
                                   int D, int ncols, void* stream) {
  return spmm::launch_short<float, false>(
      row_ptr, bcols, blocks, Br, Bc, V, D, out, Kbr, G, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
