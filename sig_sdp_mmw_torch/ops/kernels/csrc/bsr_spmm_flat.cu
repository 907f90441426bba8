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
//   * each [128, 32] slice of a block and the matching [32, 64] slice of V go
//     through shared memory once, loaded with coalesced (16-byte for bf16)
//     reads; V is rounded to the block dtype as it is staged;
//   * bf16 blocks multiply on the tensor cores (WMMA m16n16k16, fp32
//     accumulate: each bf16 x bf16 product is exact in fp32, so this equals
//     the TPU kernel's preferred_element_type=float32 dot up to summation
//     order); float32 blocks use fp32 FMA on the CUDA cores, keeping full
//     float32 precision (no TF32).
// Deliberately simple: no cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;   // block rows
constexpr int BC = 128;   // block cols
constexpr int DT = 64;    // output columns per CTA
constexpr int KC = 32;    // contraction slice staged per pass
constexpr int NT = 256;   // threads per CTA

// ---------------------------------------------------------------------------
// float32 blocks: CUDA-core FMA.  Thread (ty, tx) owns rows ty*8..+8 and
// columns tx*4..+4 of the [128, 64] tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
bsr_spmm_flat_f32(const int* __restrict__ row_ptr,
                  const int* __restrict__ bcols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ V, float* __restrict__ out,
                  int G, int D) {
  __shared__ float As[KC][BR + 1];   // A slice, transposed; +1 avoids bank conflicts
  __shared__ __align__(16) float Vs[KC][DT];

  const int r = blockIdx.y;
  const int d0 = blockIdx.x * DT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t ld = (int64_t)G * BC;   // row stride inside one step's slab

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int s0 = row_ptr[r], s1 = row_ptr[r + 1];
  for (int s = s0; s < s1; ++s) {
    const float* slab = blocks + (int64_t)s * BR * ld;
    for (int g = 0; g < G; ++g) {
      const int64_t vrow0 = (int64_t)bcols[(int64_t)s * G + g] * BC;
      for (int k0 = 0; k0 < BC; k0 += KC) {
#pragma unroll
        for (int e = 0; e < (BR * KC) / NT; ++e) {
          const int idx = e * NT + tid;
          const int i = idx / KC, kk = idx % KC;
          As[kk][i] = slab[(int64_t)i * ld + g * BC + k0 + kk];
        }
#pragma unroll
        for (int e = 0; e < (KC * DT) / NT; ++e) {
          const int idx = e * NT + tid;
          const int kk = idx / DT, j = idx % DT;
          const int d = d0 + j;
          Vs[kk][j] = d < D ? V[(vrow0 + k0 + kk) * D + d] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          const float4 b = *reinterpret_cast<const float4*>(&Vs[kk][tx * 4]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = As[kk][ty * 8 + i];
            acc[i][0] = fmaf(a, b.x, acc[i][0]);
            acc[i][1] = fmaf(a, b.y, acc[i][1]);
            acc[i][2] = fmaf(a, b.z, acc[i][2]);
            acc[i][3] = fmaf(a, b.w, acc[i][3]);
          }
        }
        __syncthreads();
      }
    }
  }

  const int dc = d0 + tx * 4;
  if (dc < D) {   // D % 8 == 0, so a 4-column group is all in or all out
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = (int64_t)r * BR + ty * 8 + i;
      *reinterpret_cast<float4*>(&out[row * D + dc]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 blocks: tensor cores through WMMA.  8 warps as 4 (rows) x 2
// (cols); warp (wr, wc) owns rows wr*32..+32 and columns wc*32..+32 as 2x2
// fragments of 16x16.
// ---------------------------------------------------------------------------
namespace wmma = nvcuda::wmma;

constexpr int LDA = KC + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = DT + 8;
constexpr int LDC = DT + 4;   // float elements
constexpr int AB_BYTES = (BR * LDA + KC * LDB) * 2;
constexpr int C_BYTES = BR * LDC * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

__global__ void __launch_bounds__(NT)
bsr_spmm_flat_bf16(const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols,
                   const __nv_bfloat16* __restrict__ blocks,
                   const float* __restrict__ V, float* __restrict__ out,
                   int G, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [BR][LDA]
  __nv_bfloat16* Bs = As + BR * LDA;                            // [KC][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BR][LDC], after the loop

  const int r = blockIdx.y;
  const int d0 = blockIdx.x * DT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const int64_t ld = (int64_t)G * BC;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  const int s0 = row_ptr[r], s1 = row_ptr[r + 1];
  for (int s = s0; s < s1; ++s) {
    const __nv_bfloat16* slab = blocks + (int64_t)s * BR * ld;
    for (int g = 0; g < G; ++g) {
      const int64_t vrow0 = (int64_t)bcols[(int64_t)s * G + g] * BC;
      for (int k0 = 0; k0 < BC; k0 += KC) {
        // A slice [128, 32] bf16: 512 vectors of 8 values, 2 per thread.
#pragma unroll
        for (int e = 0; e < (BR * KC / 8) / NT; ++e) {
          const int idx = e * NT + tid;
          const int i = idx / (KC / 8), kv = idx % (KC / 8);
          *reinterpret_cast<uint4*>(&As[i * LDA + kv * 8]) =
              *reinterpret_cast<const uint4*>(
                  &slab[(int64_t)i * ld + g * BC + k0 + kv * 8]);
        }
        // V slice [32, 64] float32 -> bf16: 512 float4, 2 per thread.
#pragma unroll
        for (int e = 0; e < (KC * DT / 4) / NT; ++e) {
          const int idx = e * NT + tid;
          const int kk = idx / (DT / 4), j = (idx % (DT / 4)) * 4;
          const int d = d0 + j;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (d < D)
            v = *reinterpret_cast<const float4*>(&V[(vrow0 + k0 + kk) * D + d]);
          __nv_bfloat162* dst =
              reinterpret_cast<__nv_bfloat162*>(&Bs[kk * LDB + j]);
          dst[0] = __floats2bfloat162_rn(v.x, v.y);
          dst[1] = __floats2bfloat162_rn(v.z, v.w);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], Bs + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // Stage the tile through shared memory (it reuses the A/B buffers: the
  // loop ended on a barrier) so the ragged D edge is masked per 4 columns.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              c[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < (BR * DT / 4) / NT; ++e) {
    const int idx = e * NT + tid;
    const int i = idx / (DT / 4), j = (idx % (DT / 4)) * 4;
    const int d = d0 + j;
    if (d < D)
      *reinterpret_cast<float4*>(&out[((int64_t)r * BR + i) * D + d]) =
          *reinterpret_cast<const float4*>(&Cs[i * LDC + j]);
  }
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
  const dim3 grid((D + DT - 1) / DT, Kbr);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (blk_dtype == 0) {
    bsr_spmm_flat_f32<<<grid, NT, 0, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
        static_cast<const float*>(blocks), static_cast<const float*>(V),
        static_cast<float*>(out), G, D);
  } else if (blk_dtype == 1) {
    bsr_spmm_flat_bf16<<<grid, NT, 0, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
        static_cast<const __nv_bfloat16*>(blocks), static_cast<const float*>(V),
        static_cast<float*>(out), G, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
