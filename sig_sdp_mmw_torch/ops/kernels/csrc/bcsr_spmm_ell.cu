// Block-ELL SpMM for Hopper: out = A @ V, A stored as block-ELL (every
// block-row padded to the same slot count maxblk).
//
// Replaces the TPU kernel sig_sdp_mmw_tpu/ops/bcsr.py::bcsr_spmm_pallas
// (same operands, same contract: V is cast to the block dtype, products
// accumulate in float32; padding slots point at column-block 0 and hold
// zero values).
//
// Operands (all device pointers, contiguous):
//   bcols   [Kbr, maxblk] int32 column-block id of each slot; a row's real
//           blocks come first, then padding at column-block 0
//   blocks  [Kbr, BR, maxblk, BC] float32 or bfloat16 (BR x BC = 128x128 on
//           the ring tile, any shape through the short-block tile)
//   V       [Kbr*BR, D] float32, D a multiple of 8 (float32 entry points), or
//   Vb      [Kbr*BR, ldv] bfloat16, rounded by the wrapper, zero past D
//           (bf16 entry points)
//   out     [Kbr*BR, D] float32 (written in full, no prior zeroing needed)
//
// The TPU kernel walks a (Kbr, maxblk) grid in order and accumulates each
// (row, slot) product into the output row-block resident in VMEM.  On this
// card CTAs run in no order, so one CTA per (block-row, D tile) walks its
// row's slots itself and keeps the output tile in registers: no atomics,
// deterministic sums.  A block-row stored as [BR, maxblk*128] is one flat
// block-CSR step with G = maxblk, so the tile bodies are the flat kernel's
// (spmm_tile.cuh).
//
// What bounds it: device-memory bytes.  At K = 1,009,200 (maxblk 12, 1.6%
// of block entries nonzero) an S-tilde apply needs 1.98 GB of real bf16
// blocks plus V and out, 0.71 ms at 3.35 TB/s; its 9.5e10 flop take 0.10 ms
// on the tensor cores.  The 128-row path (every product on the main paths)
// therefore:
//   * skips the 36% of slots that are padding (1.1 GB of zeros of the
//     3.10 GB stored per S-tilde operand; the rule is at ring_tile);
//   * covers all of D (48 at 1M) in one CTA, so each block leaves device
//     memory once per call, with N = D rounded up to 8..128 columns;
//   * reads V as bfloat16 rounded once by the wrapper (half the gathered V
//     bytes of float32) for bfloat16 blocks, the caller's float32 V for
//     float32 blocks (three tf32 products per pair, 3xTF32);
//   * keeps 2-5 slices of 16 KB of A per CTA in flight through a cp.async
//     ring feeding the tensor cores (bfloat16: mma.sync, two CTAs per SM;
//     float32: wgmma, one or two CTAs per SM).
// Blocks of every other shape (8x128 as the packers build it by default,
// 16x128, 32x32 in the mid-K search, the dryrun's 8x8, ...; Br x Bc at run
// time) take the short-block tensor-core tile of spmm_tile.cuh, bfloat16
// (bcsr_spmm_ell_short_launch) or float32 (bcsr_spmm_ell_short_f32_launch):
// one warp per block-row (or 8-32-row slice of one), mma.sync on the
// transposed tile so that an 8-row block fills an n8 tile, a per-warp
// cp.async ring with no CTA-wide barrier, padding slots skipped.  The
// grids are one-dimensional (block-row major, the D tiles of a row
// adjacent), so 8-row blocks at a million links (126,150 block-rows) fit
// them.

#include "spmm_tile.cuh"

namespace {

template <typename T, int N>
__global__ void __launch_bounds__(spmm::ring::NT,
                                  spmm::RingLaunch<T, N>::CTAS)
bcsr_spmm_ell_ring(const int* __restrict__ bcols, const T* __restrict__ blocks,
                   const T* __restrict__ V, int ldv, float* __restrict__ out,
                   int maxblk, int D, int ndt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t r = blockIdx.x / ndt;
  const int d0 = (blockIdx.x % ndt) * N;
  spmm::ring_tile<T, N>(bcols, blocks, V, ldv, out, r * maxblk,
                        (r + 1) * maxblk, maxblk, D, r, d0, smem);
}

template <typename T, int N>
int launch_ring_n(const int* bcols, const T* blocks, const T* V, int ldv,
                  float* out, long long Kbr, int maxblk, int D,
                  cudaStream_t st) {
  const long long ndt = (D + N - 1) / N;
  if (!spmm::v_pitch_ok<T>(ldv, D, N) || Kbr * ndt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = spmm::RingLaunch<T, N>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bcsr_spmm_ell_ring<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  bcsr_spmm_ell_ring<T, N><<<(unsigned)(Kbr * ndt),
                             spmm::ring::NT, smem, st>>>(
      bcols, blocks, V, ldv, out, maxblk, D, (int)ndt);
  return (int)cudaGetLastError();
}

// 128-row blocks of dtype T through the ring tile, ncols output columns
// per CTA (one of SPMM_RING_COLS).
template <typename T>
int launch_ring(const void* bcols, const void* blocks, const void* V, int ldv,
                void* out, long long Kbr, int maxblk, int D, int ncols,
                void* stream) {
  if (Kbr <= 0 || maxblk <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0 ||
      Kbr > 0x7fffffffLL / 128)
    return (int)cudaErrorInvalidValue;
  const int* bc = static_cast<const int*>(bcols);
  const T* a = static_cast<const T*>(blocks);
  const T* v = static_cast<const T*>(V);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (ncols) {
#define SPMM_CASE(N) \
  case N:            \
    return launch_ring_n<T, N>(bc, a, v, ldv, o, Kbr, maxblk, D, st);
    SPMM_RING_COLS(SPMM_CASE)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 128-row bfloat16 blocks through the ring tile: Vb [Kbr*128, ldv] bf16,
// ncols output columns per CTA (8, 16, 32, 48, 64, 96 or 128; ldv >=
// ceil(D / ncols) * ncols), out [Kbr*128, D] float32.  Returns the
// cudaError_t of the launch (0 = launched).
int bcsr_spmm_ell_bf16_launch(const void* bcols, const void* blocks,
                              const void* Vb, int ldv, void* out,
                              long long Kbr, int maxblk, int D, int ncols,
                              void* stream) {
  return launch_ring<__nv_bfloat16>(bcols, blocks, Vb, ldv, out, Kbr, maxblk,
                                    D, ncols, stream);
}

// 128-row float32 blocks through the ring tile (3xTF32): V [Kbr*128, D]
// float32, ncols as above, out [Kbr*128, D] float32.  Returns the
// cudaError_t of the launch.
int bcsr_spmm_ell_ring_f32_launch(const void* bcols, const void* blocks,
                                  const void* V, void* out, long long Kbr,
                                  int maxblk, int D, int ncols,
                                  void* stream) {
  return launch_ring<float>(bcols, blocks, V, D, out, Kbr, maxblk, D, ncols,
                            stream);
}

// bfloat16 blocks of any shape but 128x128 (8x128 included) through the
// short-block tensor-core tile (spmm_tile.cuh): block-row r is one step of
// G = maxblk slots; Vb [Kbr*Br, ldv] bf16, rounded by the wrapper, ncols
// output columns per warp (16, 32, 48, 64, 96 or 128; ldv >= ceil(D /
// ncols) * ncols), out [Kbr*Br, D] float32.  Returns the cudaError_t of
// the launch.
int bcsr_spmm_ell_short_launch(const void* bcols, const void* blocks, int Br,
                               int Bc, const void* Vb, int ldv, void* out,
                               long long Kbr, int maxblk, int D, int ncols,
                               void* stream) {
  return spmm::launch_short<__nv_bfloat16, true>(
      nullptr, bcols, blocks, Br, Bc, Vb, ldv, out, Kbr, maxblk, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

// Float32 blocks of any shape but 128x128 through the short-block tile
// (3xTF32): V [Kbr*Br, D] float32, ncols as above, out [Kbr*Br, D]
// float32.  Returns the cudaError_t of the launch.
int bcsr_spmm_ell_short_f32_launch(const void* bcols, const void* blocks,
                                   int Br, int Bc, const void* V, void* out,
                                   long long Kbr, int maxblk, int D,
                                   int ncols, void* stream) {
  return spmm::launch_short<float, true>(
      nullptr, bcols, blocks, Br, Bc, V, D, out, Kbr, maxblk, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
