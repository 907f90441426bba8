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
//           the ring and FMA tiles, any shape through the short-block and
//           generic tiles)
//   V       [Kbr*BR, D] float32, D a multiple of 8 (FMA entry point), or
//   Vb      [Kbr*BR, ldv] bfloat16, rounded by the wrapper, zero past D
//           (bf16 entry point)
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
// on the tensor cores.  The 128-row bf16 path (every product on the main
// paths) therefore:
//   * skips the 36% of slots that are padding (1.1 GB of zeros of the
//     3.10 GB stored per S-tilde operand; the rule is at ring_tile_bf16);
//   * covers all of D (48 at 1M) in one CTA, so each block leaves device
//     memory once per call, with N = D rounded up to 8..128 columns;
//   * reads V as bfloat16 rounded once by the wrapper (half the gathered V
//     bytes of float32);
//   * keeps 2-3 slices of 16 KB of A per CTA in flight through a cp.async
//     ring, two CTAs per SM, with mma.sync bf16 on the tensor cores.
// 128-row and 8x128 float32 blocks (off the main paths) take fp32 FMA on
// the CUDA cores, 64 columns per CTA, every slot walked, and float32
// blocks of every other shape the generic FMA tile.  bfloat16 blocks of
// every other shape (8x128 as the packers build it by default, 16x128,
// 32x32 in the mid-K search, 16x16, ...; Br x Bc at run time) take the
// short-block tensor-core tile of spmm_tile.cuh (bcsr_spmm_ell_short_launch):
// one warp per block-row (or 8-32-row slice of one), mma.sync on the
// transposed tile so that an 8-row block fills an n8 tile, a per-warp
// cp.async ring with no CTA-wide barrier, padding slots skipped, V read as
// bfloat16 rounded once by the wrapper.  The grids are one-dimensional
// (block-row major, the D tiles of a row adjacent), so 8-row blocks at a
// million links (126,150 block-rows) fit them.

#include "spmm_tile.cuh"

namespace {

template <int BR>
__global__ void __launch_bounds__(spmm::Fma<BR>::NT)
bcsr_spmm_ell_fma(const int* __restrict__ bcols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ V, float* __restrict__ out,
                  int maxblk, int D, int ndt) {
  const int64_t r = blockIdx.x / ndt;
  const int d0 = (blockIdx.x % ndt) * spmm::DT;
  spmm::fma_tile<BR>(bcols, blocks, V, out, (int)r, (int)r + 1, maxblk, D, r,
                     d0);
}

template <int N>
__global__ void __launch_bounds__(spmm::ring::NT, 2)
bcsr_spmm_ell_ring(const int* __restrict__ bcols,
                   const __nv_bfloat16* __restrict__ blocks,
                   const __nv_bfloat16* __restrict__ Vb, int ldv,
                   float* __restrict__ out, int maxblk, int D, int ndt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t r = blockIdx.x / ndt;
  const int d0 = (blockIdx.x % ndt) * N;
  spmm::ring_tile_bf16<N>(bcols, blocks, Vb, ldv, out, r * maxblk,
                          (r + 1) * maxblk, maxblk, D, r, d0, smem);
}

// Float32 blocks of any other shape through the generic tile: block-row r
// is one step of G = maxblk slots.
__global__ void __launch_bounds__(spmm::gen::NT)
bcsr_spmm_ell_generic(const int* __restrict__ bcols,
                      const float* __restrict__ blocks,
                      const float* __restrict__ V, float* __restrict__ out,
                      int maxblk, int Br, int Bc, int D, int nrc, int ndt) {
  const spmm::GenericItem it = spmm::generic_item(nrc, ndt);
  spmm::generic_tile(bcols, blocks, V, out, it.r * maxblk,
                     (it.r + 1) * maxblk, maxblk, Br, Bc, D, it.r, it.r0,
                     it.d0);
}

template <int N>
int launch_ring(const int* bcols, const __nv_bfloat16* blocks,
                const __nv_bfloat16* Vb, int ldv, float* out, long long Kbr,
                int maxblk, int D, cudaStream_t st) {
  const long long ndt = (D + N - 1) / N;
  if (ldv < ndt * N || Kbr * ndt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = spmm::ring::Cfg<N>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bcsr_spmm_ell_ring<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bcsr_spmm_ell_ring<N><<<(unsigned)(Kbr * ndt), spmm::ring::NT, smem, st>>>(
      bcols, blocks, Vb, ldv, out, maxblk, D, (int)ndt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float32 blocks through the FMA tile, float32 V; brow: 128 or 8.  Returns
// the cudaError_t of the launch (0 = launched).
int bcsr_spmm_ell_launch(const void* bcols, const void* blocks, int brow,
                         const void* V, void* out, long long Kbr, int maxblk,
                         int D, void* stream) {
  if (Kbr <= 0 || maxblk <= 0 || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long ndt = (D + spmm::DT - 1) / spmm::DT;
  if (Kbr * ndt > 0x7fffffffLL || Kbr > 0x7fffffffLL / 128)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(Kbr * ndt));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* bc = static_cast<const int*>(bcols);
  const float* a = static_cast<const float*>(blocks);
  const float* v = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  const int nd = (int)ndt;
  if (brow == 128)
    bcsr_spmm_ell_fma<128><<<grid, spmm::Fma<128>::NT, 0, st>>>(
        bc, a, v, o, maxblk, D, nd);
  else if (brow == 8)
    bcsr_spmm_ell_fma<8><<<grid, spmm::Fma<8>::NT, 0, st>>>(
        bc, a, v, o, maxblk, D, nd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Float32 blocks of any other shape (Br x Bc at run time) through the
// generic tile (spmm_tile.cuh): float32 V [Kbr*Br, D], D a multiple of 8;
// out [Kbr*Br, D] float32.  Returns the cudaError_t of the launch.
int bcsr_spmm_ell_generic_launch(const void* bcols, const void* blocks,
                                 int Br, int Bc, const void* V, void* out,
                                 long long Kbr, int maxblk, int D,
                                 void* stream) {
  const unsigned grid = spmm::generic_grid(Kbr, Br, D);
  if (Kbr <= 0 || maxblk <= 0 || Br <= 0 || Bc <= 0 || D <= 0 ||
      D % 8 != 0 || grid == 0)
    return (int)cudaErrorInvalidValue;
  bcsr_spmm_ell_generic<<<grid, spmm::gen::NT, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bcols), static_cast<const float*>(blocks),
      static_cast<const float*>(V), static_cast<float*>(out), maxblk, Br, Bc,
      D, (Br + spmm::gen::RM - 1) / spmm::gen::RM,
      (D + spmm::DT - 1) / spmm::DT);
  return (int)cudaGetLastError();
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
  return spmm::launch_short_bf16<true>(
      nullptr, bcols, blocks, Br, Bc, Vb, ldv, out, Kbr, maxblk, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

// 128-row bfloat16 blocks through the ring tile: Vb [Kbr*128, ldv] bf16,
// ncols output columns per CTA (8, 16, 32, 48, 64, 96 or 128; ldv >=
// ceil(D / ncols) * ncols), out [Kbr*128, D] float32.  Returns the
// cudaError_t of the launch (0 = launched).
int bcsr_spmm_ell_bf16_launch(const void* bcols, const void* blocks,
                              const void* Vb, int ldv, void* out,
                              long long Kbr, int maxblk, int D, int ncols,
                              void* stream) {
  if (Kbr <= 0 || maxblk <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0 ||
      Kbr > 0x7fffffffLL / 128)
    return (int)cudaErrorInvalidValue;
  const int* bc = static_cast<const int*>(bcols);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(blocks);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(Vb);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (ncols) {
#define SPMM_CASE(N) \
  case N:            \
    return launch_ring<N>(bc, a, v, ldv, o, Kbr, maxblk, D, st);
    SPMM_RING_COLS(SPMM_CASE)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
