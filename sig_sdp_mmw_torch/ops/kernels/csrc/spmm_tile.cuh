// Device code shared by the block-sparse SpMM kernels of the port
// (bsr_spmm_flat.cu: flat block-CSR; bcsr_spmm_ell.cu: block-ELL).
//
// One CTA computes one output tile
//
//   out[r*BR : (r+1)*BR, d0 : d0+DT] =
//       sum over steps s in [s0, s1) and slots g in [0, G) of
//       blocks[s][:, g*BC : (g+1)*BC] @ Vb[bcols[s*G+g]*BC : +BC, d0 : d0+DT]
//
// where blocks[s] is a [BR, G*BC] slab (G dense blocks side by side) and Vb
// is V rounded to the block dtype as it is staged.  A flat block-CSR row owns
// the consecutive steps row_ptr[r]..row_ptr[r+1]; a block-ELL row stored as
// [BR, maxblk*BC] is exactly one such step with G = maxblk.  The tile stays
// in registers for the CTA's whole walk and is written once: no atomics, no
// cross-CTA reduction, deterministic sums.  Element offsets are 64-bit (one
// million-link operand holds 1.55e9 elements).
//
// Two tile bodies:
//   * fma_tile<BR, T>: CUDA-core fp32 FMA, any block dtype T (float or
//     bfloat16; bf16 x bf16-rounded products are exact in fp32), BR = 128 or
//     8.  Float32 blocks keep full float32 precision (no TF32).
//   * wmma_tile_bf16: bfloat16 128-row blocks on the tensor cores (WMMA
//     m16n16k16, fp32 accumulate).
// Each [BR, 32] slice of a block and the matching [32, 64] slice of V go
// through shared memory once per pass, loaded with coalesced reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace spmm {

constexpr int BC = 128;   // block cols
constexpr int DT = 64;    // output columns per CTA
constexpr int KC = 32;    // contraction slice staged per pass

// Thread layout of the FMA tile: 16 groups of 4 output columns times
// min(BR, 16) row groups of BR / min(BR, 16) rows each.
template <int BR>
struct Fma {
  static constexpr int TY = BR < 16 ? BR : 16;
  static constexpr int NT = TY * (DT / 4);   // 256 threads for BR=128, 128 for BR=8
  static constexpr int RPT = BR / TY;        // rows per thread
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V's value as the TPU kernel sees it: cast to the block dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int BR, typename T>
__device__ __forceinline__ void fma_tile(const int* __restrict__ bcols,
                                         const T* __restrict__ blocks,
                                         const float* __restrict__ V,
                                         float* __restrict__ out, int s0,
                                         int s1, int G, int D, int64_t r,
                                         int d0) {
  constexpr int NT = Fma<BR>::NT;
  constexpr int RPT = Fma<BR>::RPT;
  __shared__ float As[KC][BR + 1];   // A slice, transposed; +1 avoids bank conflicts
  __shared__ __align__(16) float Vs[KC][DT];

  const int tid = threadIdx.x;
  const int ty = tid / (DT / 4), tx = tid % (DT / 4);
  const int64_t ld = (int64_t)G * BC;   // row stride inside one step's slab

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const T* slab = blocks + (int64_t)s * BR * ld;
    for (int g = 0; g < G; ++g) {
      const int64_t vrow0 = (int64_t)bcols[(int64_t)s * G + g] * BC;
      for (int k0 = 0; k0 < BC; k0 += KC) {
#pragma unroll
        for (int e = 0; e < (BR * KC) / NT; ++e) {
          const int idx = e * NT + tid;
          const int i = idx / KC, kk = idx % KC;
          As[kk][i] = to_f32(slab[(int64_t)i * ld + g * BC + k0 + kk]);
        }
#pragma unroll
        for (int e = 0; e < (KC * DT) / NT; ++e) {
          const int idx = e * NT + tid;
          const int kk = idx / DT, j = idx % DT;
          const int d = d0 + j;
          Vs[kk][j] = d < D ? round_to<T>(V[(vrow0 + k0 + kk) * D + d]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          const float4 b = *reinterpret_cast<const float4*>(&Vs[kk][tx * 4]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float a = As[kk][ty * RPT + i];
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
    for (int i = 0; i < RPT; ++i) {
      const int64_t row = r * BR + ty * RPT + i;
      *reinterpret_cast<float4*>(&out[row * D + dc]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 128-row blocks on the tensor cores.  256 threads = 8 warps as 4
// (rows) x 2 (cols); warp (wr, wc) owns rows wr*32..+32 and columns
// wc*32..+32 as 2x2 fragments of 16x16.
// ---------------------------------------------------------------------------
constexpr int WMMA_NT = 256;
constexpr int LDA = KC + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = DT + 8;
constexpr int LDC = DT + 4;   // float elements
constexpr int AB_BYTES = (128 * LDA + KC * LDB) * 2;
constexpr int C_BYTES = 128 * LDC * 4;
constexpr int WMMA_SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

// Writes a [128, DT] float tile held as 2x2 WMMA accumulators per warp to
// out (row block r, columns d0..), through shared memory Cs [128][LDC] so the
// ragged D edge is masked per 4 columns.  Cs may alias the caller's staging
// buffers: this starts with a barrier.
__device__ __forceinline__ void wmma_store_tile(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&c)[2][2],
    float* Cs, float* __restrict__ out, int D, int64_t r, int d0) {
  namespace wmma = nvcuda::wmma;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              c[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < (128 * DT / 4) / WMMA_NT; ++e) {
    const int idx = e * WMMA_NT + tid;
    const int i = idx / (DT / 4), j = (idx % (DT / 4)) * 4;
    const int d = d0 + j;
    if (d < D)
      *reinterpret_cast<float4*>(&out[(r * 128 + i) * D + d]) =
          *reinterpret_cast<const float4*>(&Cs[i * LDC + j]);
  }
}

__device__ __forceinline__ void wmma_tile_bf16(
    const int* __restrict__ bcols, const __nv_bfloat16* __restrict__ blocks,
    const float* __restrict__ V, float* __restrict__ out, int s0, int s1,
    int G, int D, int64_t r, int d0) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) unsigned char smem[WMMA_SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [128][LDA]
  __nv_bfloat16* Bs = As + 128 * LDA;                           // [KC][LDB]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const int64_t ld = (int64_t)G * BC;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int s = s0; s < s1; ++s) {
    const __nv_bfloat16* slab = blocks + (int64_t)s * 128 * ld;
    for (int g = 0; g < G; ++g) {
      const int64_t vrow0 = (int64_t)bcols[(int64_t)s * G + g] * BC;
      for (int k0 = 0; k0 < BC; k0 += KC) {
        // A slice [128, 32] bf16: 512 vectors of 8 values, 2 per thread.
#pragma unroll
        for (int e = 0; e < (128 * KC / 8) / WMMA_NT; ++e) {
          const int idx = e * WMMA_NT + tid;
          const int i = idx / (KC / 8), kv = idx % (KC / 8);
          *reinterpret_cast<uint4*>(&As[i * LDA + kv * 8]) =
              *reinterpret_cast<const uint4*>(
                  &slab[(int64_t)i * ld + g * BC + k0 + kv * 8]);
        }
        // V slice [32, 64] float32 -> bf16: 512 float4, 2 per thread.
#pragma unroll
        for (int e = 0; e < (KC * DT / 4) / WMMA_NT; ++e) {
          const int idx = e * WMMA_NT + tid;
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
  // The tile leaves through shared memory, reusing the A/B buffers.
  wmma_store_tile(c, reinterpret_cast<float*>(smem), out, D, r, d0);
}

}  // namespace spmm
