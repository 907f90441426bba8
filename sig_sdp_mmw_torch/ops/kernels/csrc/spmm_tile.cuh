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
// Four tile bodies:
//   * fma_tile<BR>: CUDA-core fp32 FMA for float32 blocks, BR = 128 or
//     8, N = DT = 64 columns.  Float32 blocks keep full float32 precision
//     (no TF32).  Each [BR, 32] slice of a block and the matching [32, 64]
//     slice of V go through shared memory once per pass; every slot is
//     walked, padding included.
//   * ring_tile_bf16<N>: bfloat16 128-row blocks on the tensor cores
//     (mma.sync m16n8k16, fp32 sums), all of D up to 128 in one CTA, padding
//     slots skipped, V pre-rounded, blocks streamed through a cp.async ring
//     (design notes at its definition below);
//   * generic_tile: the FMA body of float32 blocks of any other shape;
//   * short_bf16<N, R, ELL>: bfloat16 blocks of any shape but 128x128 on
//     the tensor cores, one warp per block-row (or slice of one), the tile
//     computed transposed so that 8-row blocks fill the MMAs.

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

template <int BR>
__device__ __forceinline__ void fma_tile(const int* __restrict__ bcols,
                                         const float* __restrict__ blocks,
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
// Float32 blocks of any shape (generic_tile): the body of every float32
// (Br, Bc) that the FMA tiles above do not take (128x128, and 8x128 on
// block-ELL), with Br and Bc given at run time.
//
// One CTA owns out[r*Br + r0 : +min(128, Br - r0), d0 : d0+64]: a block-row
// taller than 128 rows is split into 128-row chunks, each its own CTA.  The
// CTA walks its row's slots j in [j0, j1) in order, skipping padding by the
// rule of ring::next_real (a slot after the row's first at column-block 0
// holds zeros), and for each slot stages [rows, KC] slices of A (transposed)
// and the matching [KC, 64] slice of V in shared memory; the tail of a Bc
// that is not a multiple of KC is staged as zeros past Bc.  fp32 FMA on the
// CUDA cores (no TF32).  Thread (ty, tx) owns rows ty + 16*i (i < 8) and
// columns tx*4 .. +4.  The tile stays in registers and is written once: no
// atomics, deterministic sums.
// ---------------------------------------------------------------------------
namespace gen {

constexpr int NT = 256;
constexpr int TX = DT / 4;      // 16 groups of 4 output columns
constexpr int TY = NT / TX;     // 16 thread rows
constexpr int RM = 128;         // output rows per CTA
constexpr int RPT = RM / TY;    // 8 rows per thread

}  // namespace gen

__device__ __forceinline__ void generic_tile(
    const int* __restrict__ bcols, const float* __restrict__ blocks,
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
    const float* a = blocks + (s * Br + r0) * ld + (j - s * G) * Bc;
    const int64_t vrow0 = (int64_t)__ldg(bcols + j) * Bc;
    for (int k0 = 0; k0 < Bc; k0 += KC) {
      const int kn = min(KC, Bc - k0);
      for (int idx = tid; idx < rows * KC; idx += NT) {
        const int i = idx / KC, kk = idx % KC;
        As[kk][i] = kk < kn ? a[(int64_t)i * ld + k0 + kk] : 0.f;
      }
      for (int idx = tid; idx < KC * DT; idx += NT) {
        const int kk = idx / DT, c = idx % DT;
        const int d = d0 + c;
        Vs[kk][c] = kk < kn && d < D ? V[(vrow0 + k0 + kk) * D + d] : 0.f;
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

// Flat block-CSR float32 blocks through the generic tile (bsr_spmm_flat.cu,
// and the V-resident kernel's float32 shapes other than 128x128).
__global__ void __launch_bounds__(gen::NT)
flat_generic(const int* __restrict__ row_ptr, const int* __restrict__ bcols,
             const float* __restrict__ blocks, const float* __restrict__ V,
             float* __restrict__ out, int G, int Br, int Bc, int D, int nrc,
             int ndt) {
  const GenericItem it = generic_item(nrc, ndt);
  generic_tile(bcols, blocks, V, out, (int64_t)row_ptr[it.r] * G,
               (int64_t)row_ptr[it.r + 1] * G, G, Br, Bc, D, it.r, it.r0,
               it.d0);
}

// Grid size of a generic launch (0 if it does not fit a 1-D grid).
inline unsigned generic_grid(long long Kbr, int Br, int D) {
  const long long items =
      Kbr * ((Br + gen::RM - 1) / gen::RM) * ((D + DT - 1) / DT);
  return items > 0 && items <= 0x7fffffffLL ? (unsigned)items : 0u;
}

// Launch of flat_generic (float32 blocks, float32 V [nrows, D]).  Returns
// the cudaError_t of the launch.
inline int launch_flat_generic(const void* row_ptr, const void* bcols,
                               const void* blocks, int Br, int Bc,
                               const void* V, void* out, int Kbr, int G,
                               int D, cudaStream_t st) {
  const unsigned grid = generic_grid(Kbr, Br, D);
  if (Kbr <= 0 || G <= 0 || Br <= 0 || Bc <= 0 || D <= 0 || D % 8 != 0 ||
      grid == 0)
    return (int)cudaErrorInvalidValue;
  flat_generic<<<grid, gen::NT, 0, st>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
      static_cast<const float*>(blocks), static_cast<const float*>(V),
      static_cast<float*>(out), G, Br, Bc, D, (Br + gen::RM - 1) / gen::RM,
      (D + DT - 1) / DT);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 blocks of every shape but 128x128 on the tensor cores
// (short_bf16): the body of 8x128 (the packers' default), 8x8, 16x16,
// the mid-K search's 32x32, blocks taller than 128 rows, Bc not a multiple
// of 16, ..., with Br and Bc given at run time.
//
// The unit of work is a warp, not a CTA.  A warp owns one output tile of
// RW = 8*NTW rows and N columns of D at a time (N = D rounded up to
// 16..128, V's columns past D zero), an item:
//   * a block-row no taller than RW is merged with the next ones into one
//     item, R = RW / Br block-rows (four 8-row block-rows, two 16-row ones,
//     one 32-row one; R is a template parameter, so a short merge keeps
//     fewer registers): the warp walks the union of their column-blocks in
//     ascending order, and for each column-block copies V's slice once and
//     the block of every merged row that has it (zeros for a row that does
//     not).  Neighbouring block-rows of a banded operand share most of
//     their column-blocks, so the merged rows gather V's slice once where
//     each 8-row block alone would pull 12 KB of V (Bc = 128, D = 48) for
//     its 2 KB;
//   * a taller block-row is cut into RW-row slices, each an item.
// The tile is computed transposed,
//
//   out[rows, cols]^T  =  V[k, cols]^T  .  A[rows, k]^T,
//
// with mma.sync m16n8k16 bf16 -> fp32: M is D (N/16 m16 tiles), N is the
// item's rows (NTW n8 tiles: an 8-row block fills one, where the ring
// tile's orientation, m16 over rows, would leave half of every MMA empty),
// K is Bc (k16 steps).  The A operand is V as it lies in shared memory,
// rows k with D contiguous, through ldmatrix.trans; the B operand is the
// blocks' rows as stored, k contiguous, through plain ldmatrix.
//
// The warps are persistent: the grid holds as many CTAs of W = 4 warps as
// fit on the card at once, and warp w takes items w, w + T, w + 2T, ...
// (T warps in all, the D tiles of an item's rows adjacent), so the four
// warps of a CTA hold neighbouring block-rows at a time, no wave is left
// half empty and the work is fixed by the launch, not by a counter.  Each
// warp streams 32-deep slices (its blocks' rows [*, k0 : k0+32] and V rows
// [k0, k0+32] of the column-block, columns d0 .. d0+N) through its own
// ring of STAGES slices in shared memory with cp.async, 16 bytes at a
// time, STAGES-1 slices in flight while the tensor cores work, across the
// end of one item into the next; warps share nothing and never meet at a
// CTA-wide barrier (__syncwarp only).  A slice past Bc is zero-filled in
// shared memory up to the next multiple of 16 (Bc = 40: the last slice is
// 8 deep, padded to 16); a Bc that is not a multiple of 8 copies the
// blocks two bytes at a time.  V is read as bfloat16, rounded once by the
// wrapper (the plain version's round-to-nearest-even); both bypass L1.
// Shared rows are padded by 16 bytes so the eight row addresses of an
// ldmatrix fall in distinct banks.  Padding slots are skipped by
// ring::next_real's rule, read from a window of eight slots per merged row
// that the warp's lanes hold, so the slot indices cost one load per eight
// slots.  Sums stay in fp32 registers and each item is stored once: no
// atomics, two launches bitwise equal.  Element offsets are 64-bit; slot
// indices 32-bit (an operand has fewer than 2^31 slots, which the wrappers
// check).
// ---------------------------------------------------------------------------
namespace sb {

// SPMM_SHORT_NO_MMA drops the tensor-core work, so that
// experiments/bench_short_parts.py can time the loads alone (its result is
// wrong).
constexpr int W = 4;              // warps per CTA
constexpr int NT = W * 32;
constexpr int KS = 32;            // contraction depth of one slice
constexpr int LDA = KS + 8;       // bf16 pitch of a block row in a slice (80 B)
constexpr int RMAX = 4;           // block-rows merged into one item, at most

template <int N>
struct Cfg {
  static_assert(N % 16 == 0 && N >= 16 && N <= 128, "N: 16..128, step 16");
  static constexpr int MT = N / 16;             // m16 tiles over D
  static constexpr int NTW = N <= 64 ? 4 : 2;   // n8 tiles: 64 fp32 sums at most
  static constexpr int RW = 8 * NTW;            // output rows of an item
  static constexpr int LDV = N + 8;             // bf16 pitch of a V row
  static constexpr int A_BYTES = RW * LDA * 2;
  static constexpr int V_BYTES = KS * LDV * 2;
  static constexpr int STAGE = A_BYTES + V_BYTES;
  static constexpr int STAGES = N <= 32 ? 4 : N <= 64 ? 3 : 2;
  static constexpr int WARP_SMEM = STAGES * STAGE;
  // 65,536 to 86,016 bytes (N = 16 .. 64), 63,488 / 79,872 at N = 96 / 128.
  static constexpr int SMEM = W * WARP_SMEM;
};

// Work geometry of a launch: items are (unit, D tile), unit-major; a unit
// is R merged block-rows (nsl = 1) or one RW-row slice of a block-row.
struct Geom {
  int G, Br, Bc, D, R, nsl, ndt;
  int64_t Kbr, items;
};

// Rows of one unit: block-rows rb .. rb+nrow-1 (rq rows of each, from row
// r0 of the block), rows output rows in all.
struct Unit {
  int64_t rb;
  int nrow, r0, rows, rq;
};


__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
  st_shared16(dst, 0u, 0u, 0u, 0u);
}

}  // namespace sb

// The items of a launch: the rows of each and the slots of each block-row.
template <int N, bool ELL>
struct ShortWalk {
  using C = sb::Cfg<N>;
  const int* __restrict__ row_ptr;
  sb::Geom g;
  int64_t stride;   // T, warps in the launch

  // The rows of item it.
  __device__ __forceinline__ sb::Unit unit(int64_t it) const {
    const int64_t u = it / g.ndt;
    sb::Unit x;
    if (g.nsl == 1) {   // R merged block-rows
      x.rb = u * g.R;
      const int64_t left = g.Kbr - x.rb;
      x.nrow = left < g.R ? (int)left : g.R;
      x.r0 = 0;
      x.rq = g.Br;
      x.rows = x.nrow * g.Br;
    } else {            // one RW-row slice of a taller block-row
      x.rb = u / g.nsl;
      x.nrow = 1;
      x.r0 = (int)(u - x.rb * g.nsl) * C::RW;
      x.rq = x.rows = g.Br - x.r0 < C::RW ? g.Br - x.r0 : C::RW;
    }
    return x;
  }

  // Slots [j0, j1) of block-row r (fewer than 2^31 slots in all).
  __device__ __forceinline__ void slots(int64_t r, int& j0, int& j1) const {
    j0 = ELL ? (int)r * g.G : __ldg(row_ptr + r) * g.G;
    j1 = ELL ? j0 + g.G : __ldg(row_ptr + r + 1) * g.G;
  }
};

// RMAX: the block-rows merged into an item (g.R; fewer in the last item),
// a template parameter so that a short merge keeps fewer registers.
template <int N, int RMAX, bool ELL>
__global__ void __launch_bounds__(sb::NT)
short_bf16(const int* __restrict__ row_ptr, const int* __restrict__ bcols,
           const __nv_bfloat16* __restrict__ blocks,
           const __nv_bfloat16* __restrict__ Vb, int ldv,
           float* __restrict__ out, sb::Geom g) {
  using C = sb::Cfg<N>;
  constexpr int S = C::STAGES;
  constexpr int KS = sb::KS, LDA = sb::LDA;
  static_assert(RMAX == 1 || RMAX == 2 || RMAX == 4, "merge: 1, 2 or 4");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t base =
      ring::smem_addr(smem) + (uint32_t)(warp * C::WARP_SMEM);
  const ShortWalk<N, ELL> walk{row_ptr, g, (int64_t)gridDim.x * sb::W};
  const int64_t first = (int64_t)blockIdx.x * sb::W + warp;
  const int64_t ld = (int64_t)g.G * g.Bc;   // row stride inside a slab
  const bool aligned = g.Bc % 8 == 0;       // every block piece on 16 bytes

  // ---- producer: item pit; merged row q at slot pj[q] < pe[q], whose
  // column-block is pc[q] (END once the row is done) ----
  constexpr int END = 0x7fffffff;
  const unsigned FULL = 0xffffffffu;
  int64_t pit = first;
  sb::Unit pu{};
  int pj[RMAX] = {}, pe[RMAX] = {};
  int64_t pa[RMAX] = {};   // element offset of row q's block at slot pj[q]
  int pc[RMAX];
  int pmask = 0, pcol = 0, kq = 0, issued = 0, pd0 = 0;
  int pv = 0;               // this lane's entry of the slot windows (below)
  // Per stage, four bits: k16 steps (bits 0-1) and the item's end (bit 3).
  uint32_t meta_ring = 0;
  // Offset of the block at slot j (step j / G, group j % G) for the
  // item's rows: lane q computes row q's, once per column-block.
  auto block_offset = [&](int j) -> int64_t {
    const int s = j / g.G;
    return ((int64_t)s * g.Br + pu.r0) * ld + (int64_t)(j - s * g.G) * g.Bc;
  };
  // Row q's entry of a per-row register array (q differs across lanes).
  auto pick = [](const int (&x)[RMAX], int q) {
    int v = x[0];
#pragma unroll
    for (int r = 1; r < RMAX; ++r)
      if (q == r) v = x[r];
    return v;
  };
  // A window of slots per row, held across the warp: lane 8q + o - 1 holds
  // pv = the column-block of row q's slot pw[q] + o (o = 1..8; 0 past the
  // row's end).  A row's next real slot is looked up in its window, so the
  // window is loaded once per eight slots, and reloaded (for the rows in
  // `rows`) as soon as the row's slot reaches its last entry: the load is
  // in flight while the warp copies and multiplies.
  int pw[RMAX] = {};
  auto load_windows = [&](int rows) {
    const int q = lane >> 3, o = (lane & 7) + 1;
    if (q < RMAX && ((rows >> q) & 1)) {
      const int j = pick(pw, q) + o;
      pv = j < pick(pe, q) ? __ldg(bcols + j) : 0;
    }
  };
  auto start_item = [&]() {
    pu = walk.unit(pit);
    pd0 = (int)(pit % g.ndt) * N;
    int j0 = 0, j1 = 0, c0 = END;
    int64_t a0 = 0;
    if (lane < pu.nrow) {   // lane q: merged row q's slots, first column
      walk.slots(pu.rb + lane, j0, j1);
      c0 = __ldg(bcols + j0);   // a row's first slot is always taken
      a0 = block_offset(j0);
    }
#pragma unroll
    for (int q = 0; q < RMAX; ++q) {
      pj[q] = pw[q] = __shfl_sync(FULL, j0, q);
      pe[q] = __shfl_sync(FULL, j1, q);
      pc[q] = __shfl_sync(FULL, c0, q);
      pa[q] = __shfl_sync(FULL, a0, q);
    }
    load_windows((1 << pu.nrow) - 1);
  };
  if (pit < g.items) start_item();

  // Advance the rows of pmask to their next real slot (ring::next_real's
  // rule: the first later slot with a nonzero column-block, or the row's
  // end), from the windows; past a window's end, one slot at a time.
  auto advance = [&]() {
    const int q = lane >> 3, o = (lane & 7) + 1;
    const int j = pick(pw, q) + o;
    const unsigned stop = __ballot_sync(
        FULL, q < RMAX && ((pmask >> q) & 1) && j > pick(pj, q) &&
                  (j >= pick(pe, q) || pv != 0));
    int reload = 0;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const unsigned bits = (stop >> (8 * r)) & 0xffu;
      const int hit = bits ? __ffs(bits) : 0;   // 1-based offset, 0: none
      const int v = __shfl_sync(FULL, pv, 8 * r + (hit ? hit - 1 : 0));
      if ((pmask >> r) & 1) {
        if (hit) {
          pj[r] = pw[r] + hit;
        } else {
          pj[r] = (int)ring::next_real(bcols, pw[r] + 8, pe[r]);
        }
        pc[r] = pj[r] >= pe[r] ? END
                : hit ? v : __ldg(bcols + pj[r]);
        if (pj[r] < pe[r] && pj[r] >= pw[r] + 8) {
          pw[r] = pj[r];
          reload |= 1 << r;
        }
      }
    }
    if (reload) load_windows(reload);
    const int64_t a = lane < RMAX && ((pmask >> lane) & 1)
                          ? block_offset(pick(pj, lane)) : 0;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int64_t ar = __shfl_sync(FULL, a, r);
      if ((pmask >> r) & 1) pa[r] = ar;
    }
  };

  auto produce = [&](int stage) {
    if (pit < g.items) {
      if (kq == 0) {   // the next column-block of the union, and its rows
        int c = END;
#pragma unroll
        for (int q = 0; q < RMAX; ++q) c = min(c, pc[q]);
        pmask = 0;
#pragma unroll
        for (int q = 0; q < RMAX; ++q)
          if (q < pu.nrow && pc[q] == c) pmask |= 1 << q;
        pcol = c;
      }
      const int kn = min(KS, g.Bc - kq);   // real depth of the slice
      const int kp = (kn + 15) & ~15;      // depth the MMAs read
      const uint32_t st = base + stage * C::STAGE;
      // Block rows: q's rows at shared rows q*rq .., zeros for a merged
      // row without this column-block.
#pragma unroll
      for (int q = 0; q < RMAX; ++q) {
        if (q >= pu.nrow) break;
        const bool has = (pmask >> q) & 1;
        const __nv_bfloat16* a = blocks + pa[q] + kq;
        for (int idx = lane; idx < pu.rq * (KS / 8); idx += 32) {
          const int i = idx / (KS / 8), c = (idx % (KS / 8)) * 8;
          if (c >= kp) continue;
          const uint32_t dst = st + ((q * pu.rq + i) * LDA + c) * 2;
          const __nv_bfloat16* src = a + i * ld + c;
          if (!has || c >= kn) {
            sb::st_shared_zero16(dst);
          } else if (aligned && c + 8 <= kn) {
            ring::cp_async16(dst, src);
          } else {
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint16_t lo = c + 2 * e < kn
                  ? __bfloat16_as_ushort(src[2 * e]) : (uint16_t)0;
              const uint16_t hi = c + 2 * e + 1 < kn
                  ? __bfloat16_as_ushort(src[2 * e + 1]) : (uint16_t)0;
              w[e] = (uint32_t)lo | ((uint32_t)hi << 16);
            }
            sb::st_shared16(dst, w[0], w[1], w[2], w[3]);
          }
        }
      }
      // V rows [kq, kq + kp) of column-block pcol, columns d0 .. d0+N.
      const __nv_bfloat16* v =
          Vb + ((int64_t)pcol * g.Bc + kq) * ldv + pd0;
      const uint32_t vs = st + C::A_BYTES;
      for (int idx = lane; idx < kp * (N / 8); idx += 32) {
        const int k = idx / (N / 8), c = (idx % (N / 8)) * 8;
        const uint32_t dst = vs + (k * C::LDV + c) * 2;
        if (k < kn)
          ring::cp_async16(dst, v + (int64_t)k * ldv + c);
        else
          sb::st_shared_zero16(dst);
      }
      uint32_t meta = (uint32_t)(kp / 16);
      kq += KS;
      if (kq >= g.Bc) {   // the column-block is done: advance its rows
        kq = 0;
        advance();
        bool more = false;
#pragma unroll
        for (int q = 0; q < RMAX; ++q) more |= pc[q] != END;
        if (!more) {   // the item is done: on to the warp's next
          meta |= 8u;
          pit += walk.stride;
          if (pit < g.items) start_item();
        }
      }
      meta_ring = (meta_ring & ~(0xfu << (4 * stage))) | (meta << (4 * stage));
      ++issued;
    }
    ring::cp_async_commit();   // possibly empty: keeps the group count fixed
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) produce(st);

  // ---- consumer: item cit ----
  int64_t cit = first;
  sb::Unit cu = cit < g.items ? walk.unit(cit) : sb::Unit{};
  float acc[C::MT][C::NTW][4];
#pragma unroll
  for (int m = 0; m < C::MT; ++m)
#pragma unroll
    for (int n = 0; n < C::NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // ldmatrix row addresses of this lane: B (block rows, k contiguous) takes
  // row lane%8 at depth 8*(lane/8), so one x4 load holds two k16 steps of
  // one n8 tile; A (V rows, D contiguous, transposed) takes V row
  // (lane%8) + 8*(lane/16) at column 8*((lane/8)%2).
  const int brow = lane & 7, bcol = (lane >> 3) * 8;
  const int vrow = (lane & 7) + (lane >> 4) * 8, vcol = ((lane >> 3) & 1) * 8;
  const int gq = lane >> 2, q2 = (lane & 3) * 2;

  for (int t = 0; t < issued; ++t) {
    ring::cp_async_wait<S - 2>();   // slice t has landed (this lane's part)
    __syncwarp();                   // ... every lane's; stage t-1 is free
    const uint32_t meta = (meta_ring >> (4 * (t % S))) & 0xfu;
    produce((t + S - 1) % S);
    const uint32_t as = base + (t % S) * C::STAGE;
    const uint32_t vs = as + C::A_BYTES;
    const int ntv = (cu.rows + 7) / 8;   // n8 tiles that hold a row
    const int ksteps = (int)(meta & 3u);
    uint32_t bf[C::NTW][4];
#pragma unroll
    for (int n = 0; n < C::NTW; ++n)
      if (n < ntv)
        ring::ldsm_x4(bf[n], as + ((n * 8 + brow) * LDA + bcol) * 2);
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      if (ks < ksteps) {
#pragma unroll
        for (int m = 0; m < C::MT; ++m) {
          uint32_t af[4];
          ring::ldsm_x4_t(af, vs + ((ks * 16 + vrow) * C::LDV + m * 16 + vcol)
                                       * 2);
#ifndef SPMM_SHORT_NO_MMA
#pragma unroll
          for (int n = 0; n < C::NTW; ++n)
            if (n < ntv)
              ring::mma_bf16(acc[m][n], af, bf[n][2 * ks], bf[n][2 * ks + 1]);
#endif
        }
      }
    }
    if (meta & 8u) {   // the item's last slice: store its tile, start anew
      // Accumulator (m, n): D columns lane/4 and lane/4 + 8 of m16 tile m,
      // rows 2*(lane%4) + 0, 1 of n8 tile n.
      const int d0 = (int)(cit % g.ndt) * N;
      const int64_t row0 = cu.rb * g.Br + cu.r0;
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
#pragma unroll
        for (int n = 0; n < C::NTW; ++n) {
          const int d = d0 + m * 16 + gq;   // D % 8 == 0: d, d + 8 each in or out
          const int i = n * 8 + q2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (i + e < cu.rows) {
              float* o = out + (row0 + i + e) * (int64_t)g.D;
              if (d < g.D) o[d] = acc[m][n][e];
              if (d + 8 < g.D) o[d + 8] = acc[m][n][2 + e];
            }
            acc[m][n][e] = acc[m][n][2 + e] = 0.f;
          }
        }
      cit += walk.stride;
      if (cit < g.items) cu = walk.unit(cit);
    }
  }
}

// The launchers have internal linkage: each kernel library keeps its own
// per-device cache below.  (A static inside an inline function with
// external linkage is one symbol for every library loaded in the process,
// so a second library would find the first one's cache filled and skip its
// own shared-memory opt-in.)
namespace {

// bfloat16 blocks Br x Bc through short_bf16<N, R>: Vb [nrows, ldv] bf16
// (ldv >= ceil(D / N) * N, a multiple of 8, columns past D zero), out
// [nrows, D] float32.  ELL: block-row r is one step of G = maxblk slots
// (row_ptr unused); else flat block-CSR, the row's steps row_ptr[r] ..
// row_ptr[r+1].  The grid is the CTAs that fit on the card at once (no
// more than the items need).
template <int N, int R, bool ELL>
inline int launch_short_r(const int* row_ptr, const int* bcols,
                          const __nv_bfloat16* blocks, int Br, int Bc,
                          const __nv_bfloat16* Vb, int ldv, float* out,
                          long long Kbr, int G, int D, cudaStream_t st) {
  using C = sb::Cfg<N>;
  sb::Geom g;
  g.G = G;
  g.Br = Br;
  g.Bc = Bc;
  g.D = D;
  g.Kbr = Kbr;
  g.ndt = (D + N - 1) / N;
  g.R = R;
  g.nsl = Br <= C::RW ? 1 : (Br + C::RW - 1) / C::RW;
  g.items = (g.nsl == 1 ? (Kbr + R - 1) / R : Kbr * g.nsl) * g.ndt;
  if (ldv < g.ndt * N || (ELL && Kbr * G > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  auto kernel = short_bf16<N, R, ELL>;
  // The shared-memory opt-in and the CTAs that fit on the card at once,
  // once per device.
  static int fit_cache[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (fit_cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  C::SMEM)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, sb::NT, C::SMEM)) != cudaSuccess)
      return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    fit_cache[dev] = sms * per_sm;
  }
  const long long need = (g.items + sb::W - 1) / sb::W;
  const long long grid = need < fit_cache[dev] ? need : fit_cache[dev];
  kernel<<<(unsigned)grid, sb::NT, C::SMEM, st>>>(row_ptr, bcols, blocks, Vb,
                                                  ldv, out, g);
  return (int)cudaGetLastError();
}

// The merge for Br: as many block-rows as fill the item's RW rows (4, 2 or
// 1, at most sb::RMAX), one for a block-row taller than RW.
template <int N, bool ELL>
inline int launch_short_n(const int* row_ptr, const int* bcols,
                          const __nv_bfloat16* blocks, int Br, int Bc,
                          const __nv_bfloat16* Vb, int ldv, float* out,
                          long long Kbr, int G, int D, cudaStream_t st) {
  const int fit = Br <= sb::Cfg<N>::RW ? sb::Cfg<N>::RW / Br : 1;
  const int r = fit < sb::RMAX ? fit : sb::RMAX;
  if constexpr (sb::Cfg<N>::RW >= 32) {
    if (r >= 4)
      return launch_short_r<N, 4, ELL>(row_ptr, bcols, blocks, Br, Bc, Vb,
                                       ldv, out, Kbr, G, D, st);
  }
  if (r >= 2)
    return launch_short_r<N, 2, ELL>(row_ptr, bcols, blocks, Br, Bc, Vb, ldv,
                                     out, Kbr, G, D, st);
  return launch_short_r<N, 1, ELL>(row_ptr, bcols, blocks, Br, Bc, Vb, ldv,
                                   out, Kbr, G, D, st);
}

// Output columns one warp of the short-block tile may cover (the
// instantiated N).
#define SPMM_SHORT_COLS(X) X(16) X(32) X(48) X(64) X(96) X(128)

// bfloat16 blocks Br x Bc through the short-block tile, ncols one of
// SPMM_SHORT_COLS (see launch_short_n).  Returns the cudaError_t of the
// launch.
template <bool ELL>
inline int launch_short_bf16(const void* row_ptr, const void* bcols,
                             const void* blocks, int Br, int Bc,
                             const void* Vb, int ldv, void* out,
                             long long Kbr, int G, int D, int ncols,
                             cudaStream_t st) {
  if (Kbr <= 0 || G <= 0 || Br <= 0 || Bc <= 0 || D <= 0 || D % 8 != 0 ||
      ldv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(blocks);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(Vb);
  float* o = static_cast<float*>(out);
  switch (ncols) {
#define SPMM_CASE(N) \
  case N:            \
    return launch_short_n<N, ELL>(rp, bc, a, Br, Bc, v, ldv, o, Kbr, G, D, st);
    SPMM_SHORT_COLS(SPMM_CASE)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace spmm
