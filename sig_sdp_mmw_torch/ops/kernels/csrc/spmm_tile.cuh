// Device code shared by the block-sparse SpMM kernels of the port
// (bsr_spmm_flat.cu: flat block-CSR; bcsr_spmm_ell.cu: block-ELL;
// bsr_spmm_vres.cu takes the block constants).
//
// One CTA computes one output tile
//
//   out[r*BR : (r+1)*BR, d0 : d0+N] =
//       sum over the row's slots j (step s = j / G, group g = j % G) of
//       blocks[s][:, g*BC : (g+1)*BC] @ Vb[bcols[j]*BC : +BC, d0 : d0+N]
//
// where blocks[s] is a [BR, G*BC] slab (G dense blocks side by side) and Vb
// is V rounded to the block dtype.  A flat block-CSR row owns the slots of
// its consecutive steps row_ptr[r]..row_ptr[r+1]; a block-ELL row stored as
// [BR, maxblk*BC] is exactly one such step with G = maxblk.  The tile stays
// in registers for the CTA's whole walk and is written once: no atomics, no
// cross-CTA reduction, deterministic sums.  Element offsets are 64-bit (one
// million-link operand holds 1.55e9 elements).
//
// Two tile bodies:
//   * fma_tile<BR, T>: CUDA-core fp32 FMA, any block dtype T (float or
//     bfloat16; bf16 x bf16-rounded products are exact in fp32), BR = 128 or
//     8, N = DT = 64 columns.  Float32 blocks keep full float32 precision
//     (no TF32).  Each [BR, 32] slice of a block and the matching [32, 64]
//     slice of V go through shared memory once per pass; every slot is
//     walked, padding included.
//   * ring_tile_bf16<N>: bfloat16 128-row blocks on the tensor cores
//     (mma.sync m16n8k16, fp32 sums), all of D up to 128 in one CTA, padding
//     slots skipped, V pre-rounded, blocks streamed through a cp.async ring
//     (design notes at its definition below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// bfloat16 128-row blocks on the tensor cores, streamed through a cp.async
// ring (ring_tile_bf16).
//
// One CTA owns the output tile out[r*128 : +128, d0 : d0+N] (N = all of D up
// to 128) and walks its row's slots j in [j0, j1) in order.  Slot j is
// step s = j / G, group g = j % G: its block is
// blocks[s*128 : +128, g*128 : +128] of a [*, G*128] slab.
//
// Padding slots are skipped.  The packers place a row's real blocks first,
// in ascending column-block order, then pad with column-block 0 and zero
// values; so a slot after the row's first slot whose column-block is 0
// holds only zeros, and the CTA neither loads nor multiplies it (the row's
// first slot is always taken: an empty row's zeros give its zero output).
//
// V arrives already rounded to bfloat16 by the wrapper (the same
// round-to-nearest-even as the plain version), [nrows, ldv] with zero
// columns past D, and is gathered 16 bytes at a time.
//
// The ring: each stage holds one 64-deep slice of a block, A [128, 64] and
// the matching V rows [64, N], copied with cp.async.cg (16 B, L1 bypassed)
// by all 256 threads.  Slice k+STAGES-1 is issued before the MMAs on slice
// k, across the row's slots, so STAGES-1 slices (16 KB of A each) are in
// flight while the tensor cores work; one barrier per slice.  Shared rows
// are padded by 16 bytes, so the ldmatrix row addresses of a warp fall in
// distinct banks.  MMAs are mma.sync m16n8k16 bf16 -> fp32 from ldmatrix
// (V with .trans); 8 warps tile [128, N] as WM x WN; the sums stay in
// registers and are stored once, float2 per thread, the D edge masked.
// ---------------------------------------------------------------------------
namespace ring {

constexpr int NT = 256;                  // 8 warps
constexpr int KS = 64;                   // contraction depth of one stage
constexpr int LDA = KS + 8;              // bf16 pitch of an A stage row (144 B)
constexpr int A_BYTES = 128 * LDA * 2;   // 18,432

template <int N>
struct Cfg {
  static_assert(N % 8 == 0 && N >= 8 && N <= 128, "N: 8..128, step 8");
  static constexpr int WN = N % 16 == 0 ? 2 : 1;   // warps across columns
  static constexpr int WM = 8 / WN;                // warps across rows
  static constexpr int MT = 128 / WM / 16;         // m16 tiles per warp
  static constexpr int NTL = N / WN / 8;           // n8 tiles per warp
  static constexpr int LDV = N + 8;                // bf16 pitch of a V row
  static constexpr int V_BYTES = KS * LDV * 2;
  static constexpr int STAGE = A_BYTES + V_BYTES;
  // Two CTAs fit on an SM at every N (at most 110,592 bytes each).
  // SPMM_RING_STAGES overrides the depth (experiments/bench_ring_parts.py).
#ifdef SPMM_RING_STAGES
  static constexpr int STAGES = SPMM_RING_STAGES;
#else
  static constexpr int STAGES = N <= 64 ? 4 : 3;
#endif
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr int SMEM = STAGES * STAGE;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a @ b on one m16n8k16 tile, bf16 inputs, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The slot after j that holds a real block (j1 if none): a slot after the
// row's first whose column-block is 0 is padding.
__device__ __forceinline__ int64_t next_real(const int* __restrict__ bcols,
                                             int64_t j, int64_t j1) {
  do {
    ++j;
  } while (j < j1 && __ldg(bcols + j) == 0);
  return j;
}

// Issue the cp.async copies of slice `half` of slot j into ring stage `st`.
template <int N>
__device__ __forceinline__ void issue(uint32_t st, const int* __restrict__ bcols,
                                      const __nv_bfloat16* __restrict__ blocks,
                                      const __nv_bfloat16* __restrict__ Vb,
                                      int ldv, int64_t j, int half, int G,
                                      int d0) {
  using C = Cfg<N>;
  const int tid = threadIdx.x;
  const int64_t s = j / G;
  const int64_t ld = (int64_t)G * BC;
  const __nv_bfloat16* a =
      blocks + s * 128 * ld + (j - s * G) * BC + half * KS;
  // A slice [128, 64]: 1,024 pieces of 16 bytes, 4 per thread.
#pragma unroll
  for (int e = 0; e < 128 * KS / 8 / NT; ++e) {
    const int idx = e * NT + tid;
    const int i = idx / (KS / 8), c = idx % (KS / 8);
    cp_async16(st + (i * LDA + c * 8) * 2, a + i * ld + c * 8);
  }
  // V rows [64, N] of the slot's column-block.
  const __nv_bfloat16* v =
      Vb + ((int64_t)__ldg(bcols + j) * BC + half * KS) * ldv + d0;
  const uint32_t vs = st + A_BYTES;
  constexpr int PIECES = KS * N / 8;
#pragma unroll
  for (int e = 0; e < (PIECES + NT - 1) / NT; ++e) {
    const int idx = e * NT + tid;
    if (PIECES % NT == 0 || idx < PIECES) {
      const int k = idx / (N / 8), c = idx % (N / 8);
      cp_async16(vs + (k * C::LDV + c * 8) * 2, v + (int64_t)k * ldv + c * 8);
    }
  }
}

}  // namespace ring

template <int N>
__device__ __forceinline__ void ring_tile_bf16(
    const int* __restrict__ bcols, const __nv_bfloat16* __restrict__ blocks,
    const __nv_bfloat16* __restrict__ Vb, int ldv, float* __restrict__ out,
    int64_t j0, int64_t j1, int G, int D, int64_t r, int d0,
    unsigned char* smem) {
  using C = ring::Cfg<N>;
  constexpr int S = C::STAGES;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = (warp / C::WN) * C::MT * 16;
  const int col0 = (warp % C::WN) * C::NTL * 8;
  // ldmatrix row address of this lane inside a 16x16 tile.
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc = (lane >> 4) * 8;
  const uint32_t base = ring::smem_addr(smem);

  float acc[C::MT][C::NTL][4];
#pragma unroll
  for (int m = 0; m < C::MT; ++m)
#pragma unroll
    for (int n = 0; n < C::NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // Producer cursor (slot jp, slice hp); every thread walks it alike.
  int64_t jp = j0;
  int hp = 0;
  int issued = 0;
  auto produce = [&](int stage) {
    if (jp < j1) {
      ring::issue<N>(base + stage * C::STAGE, bcols, blocks, Vb, ldv, jp, hp,
                     G, d0);
      ++issued;
      if (hp == 0) {
        hp = 1;
      } else {
        hp = 0;
        jp = ring::next_real(bcols, jp, j1);
      }
    }
    ring::cp_async_commit();   // possibly empty: keeps the group count fixed
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) produce(st);

  for (int t = 0; t < issued; ++t) {
    ring::cp_async_wait<S - 2>();   // slice t has landed (this thread's part)
    __syncthreads();                // ... everyone's; stage t-1 is free
    produce((t + S - 1) % S);
    const uint32_t as = base + (t % S) * C::STAGE;
    const uint32_t vs = as + ring::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < ring::KS; kk += 16) {
      uint32_t af[C::MT][4];
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
        ring::ldsm_x4(af[m],
                      as + ((row0 + m * 16 + lr) * ring::LDA + kk + lc) * 2);
      uint32_t bf[C::NTL][2];
#pragma unroll
      for (int n = 0; n + 1 < C::NTL; n += 2) {
        uint32_t b4[4];
        ring::ldsm_x4_t(b4,
                        vs + ((kk + lr) * C::LDV + col0 + n * 8 + lc) * 2);
        bf[n][0] = b4[0];
        bf[n][1] = b4[1];
        bf[n + 1][0] = b4[2];
        bf[n + 1][1] = b4[3];
      }
      if (C::NTL % 2) {
        uint32_t b2[2];
        ring::ldsm_x2_t(
            b2, vs + ((kk + lr) * C::LDV + col0 + (C::NTL - 1) * 8) * 2);
        bf[C::NTL - 1][0] = b2[0];
        bf[C::NTL - 1][1] = b2[1];
      }
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
#pragma unroll
        for (int n = 0; n < C::NTL; ++n)
          ring::mma_bf16(acc[m][n], af[m], bf[n][0], bf[n][1]);
    }
  }

  // Accumulator (m, n): rows lane/4 and lane/4 + 8, columns 2*(lane%4) + 0, 1.
  const int gr = lane / 4, gc = (lane % 4) * 2;
#pragma unroll
  for (int m = 0; m < C::MT; ++m)
#pragma unroll
    for (int n = 0; n < C::NTL; ++n) {
      const int d = d0 + col0 + n * 8 + gc;
      if (d < D) {   // D even: columns d and d+1 are both in
        const int64_t row = r * 128 + row0 + m * 16 + gr;
        *reinterpret_cast<float2*>(&out[row * D + d]) =
            make_float2(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<float2*>(&out[(row + 8) * D + d]) =
            make_float2(acc[m][n][2], acc[m][n][3]);
      }
    }
}

// Output columns one bf16 CTA may cover (the instantiated N).
#define SPMM_RING_COLS(X) X(8) X(16) X(32) X(48) X(64) X(96) X(128)

// ---------------------------------------------------------------------------
// Any block shape (generic_tile): the body of every (Br, Bc) that the fast
// paths above do not take (128x128 ring and FMA tiles, 8x128 FMA tile),
// with Br and Bc given at run time, float32 or bfloat16 blocks.
//
// One CTA owns out[r*Br + r0 : +min(128, Br - r0), d0 : d0+64]: a block-row
// taller than 128 rows is split into 128-row chunks, each its own CTA.  The
// CTA walks its row's slots j in [j0, j1) in order, skipping padding by the
// rule of ring::next_real (a slot after the row's first at column-block 0
// holds zeros), and for each slot stages [rows, KC] slices of A (transposed)
// and the matching [KC, 64] slice of V, rounded to the block dtype, in
// shared memory; the tail of a Bc that is not a multiple of KC is staged as
// zeros past Bc.  fp32 FMA on the CUDA cores (no TF32).  Thread (ty, tx)
// owns rows ty + 16*i (i < 8) and columns tx*4 .. +4, so a short block
// (Br = 8, 16, 32) keeps its rows on the low thread rows.  The tile stays in
// registers and is written once: no atomics, deterministic sums.
// ---------------------------------------------------------------------------
namespace gen {

constexpr int NT = 256;
constexpr int TX = DT / 4;      // 16 groups of 4 output columns
constexpr int TY = NT / TX;     // 16 thread rows
constexpr int RM = 128;         // output rows per CTA
constexpr int RPT = RM / TY;    // 8 rows per thread

}  // namespace gen

template <typename T>
__device__ __forceinline__ void generic_tile(
    const int* __restrict__ bcols, const T* __restrict__ blocks,
    const float* __restrict__ V, float* __restrict__ out, int64_t j0,
    int64_t j1, int G, int Br, int Bc, int D, int64_t r, int r0, int d0) {
  using namespace gen;
  __shared__ float As[KC][RM + 1];
  __shared__ __align__(16) float Vs[KC][DT];

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int rows = min(RM, Br - r0);
  const int64_t ld = (int64_t)G * Bc;   // row stride inside one step's slab

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int64_t j = j0; j < j1; j = ring::next_real(bcols, j, j1)) {
    const int64_t s = j / G;
    const T* a = blocks + (s * Br + r0) * ld + (j - s * G) * Bc;
    const int64_t vrow0 = (int64_t)__ldg(bcols + j) * Bc;
    for (int k0 = 0; k0 < Bc; k0 += KC) {
      const int kn = min(KC, Bc - k0);
      for (int idx = tid; idx < rows * KC; idx += NT) {
        const int i = idx / KC, kk = idx % KC;
        As[kk][i] = kk < kn ? to_f32(a[(int64_t)i * ld + k0 + kk]) : 0.f;
      }
      for (int idx = tid; idx < KC * DT; idx += NT) {
        const int kk = idx / DT, c = idx % DT;
        const int d = d0 + c;
        Vs[kk][c] = kk < kn && d < D
                        ? round_to<T>(V[(vrow0 + k0 + kk) * D + d])
                        : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&Vs[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (ty + TY * i < rows) {
            const float av = As[kk][ty + TY * i];
            acc[i][0] = fmaf(av, b.x, acc[i][0]);
            acc[i][1] = fmaf(av, b.y, acc[i][1]);
            acc[i][2] = fmaf(av, b.z, acc[i][2]);
            acc[i][3] = fmaf(av, b.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }

  const int dc = d0 + tx * 4;
  if (dc < D) {   // D % 8 == 0, so a 4-column group is all in or all out
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = ty + TY * i;
      if (lr < rows) {
        const int64_t row = r * Br + r0 + lr;
        *reinterpret_cast<float4*>(&out[row * D + dc]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// Work item of the generic launches: blockIdx.x = (block-row r, 128-row
// chunk, 64-column D tile), row-major, so the chunks and D tiles of one
// block-row are neighbours in the launch order (the second finds the row's
// blocks in L2).  One-dimensional: any number of block-rows up to 2^31-1
// items.
struct GenericItem {
  int64_t r;
  int r0, d0;
};

__device__ __forceinline__ GenericItem generic_item(int nrc, int ndt) {
  const int64_t idx = blockIdx.x;
  const int64_t per_row = (int64_t)nrc * ndt;
  GenericItem it;
  it.r = idx / per_row;
  const int rem = (int)(idx - it.r * per_row);
  it.r0 = (rem / ndt) * gen::RM;
  it.d0 = (rem % ndt) * DT;
  return it;
}

// Flat block-CSR through the generic tile (bsr_spmm_flat.cu, and the
// V-resident kernel's shapes other than 128x128).
template <typename T>
__global__ void __launch_bounds__(gen::NT)
flat_generic(const int* __restrict__ row_ptr, const int* __restrict__ bcols,
             const T* __restrict__ blocks, const float* __restrict__ V,
             float* __restrict__ out, int G, int Br, int Bc, int D, int nrc,
             int ndt) {
  const GenericItem it = generic_item(nrc, ndt);
  generic_tile<T>(bcols, blocks, V, out, (int64_t)row_ptr[it.r] * G,
                  (int64_t)row_ptr[it.r + 1] * G, G, Br, Bc, D, it.r, it.r0,
                  it.d0);
}

// Grid size of a generic launch (0 if it does not fit a 1-D grid).
inline unsigned generic_grid(long long Kbr, int Br, int D) {
  const long long items =
      Kbr * ((Br + gen::RM - 1) / gen::RM) * ((D + DT - 1) / DT);
  return items > 0 && items <= 0x7fffffffLL ? (unsigned)items : 0u;
}

// Launch of flat_generic: blk_dtype 0 = float32 blocks, 1 = bfloat16.
// Returns the cudaError_t of the launch.
inline int launch_flat_generic(const void* row_ptr, const void* bcols,
                               const void* blocks, int blk_dtype, int Br,
                               int Bc, const void* V, void* out, int Kbr,
                               int G, int D, cudaStream_t st) {
  const unsigned grid = generic_grid(Kbr, Br, D);
  if (Kbr <= 0 || G <= 0 || Br <= 0 || Bc <= 0 || D <= 0 || D % 8 != 0 ||
      grid == 0)
    return (int)cudaErrorInvalidValue;
  const int nrc = (Br + gen::RM - 1) / gen::RM, ndt = (D + DT - 1) / DT;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const float* v = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  if (blk_dtype == 0)
    flat_generic<float><<<grid, gen::NT, 0, st>>>(
        rp, bc, static_cast<const float*>(blocks), v, o, G, Br, Bc, D, nrc,
        ndt);
  else if (blk_dtype == 1)
    flat_generic<__nv_bfloat16><<<grid, gen::NT, 0, st>>>(
        rp, bc, static_cast<const __nv_bfloat16*>(blocks), v, o, G, Br, Bc, D,
        nrc, ndt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace spmm
