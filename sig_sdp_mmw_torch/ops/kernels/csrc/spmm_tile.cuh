// Device code shared by the block-sparse SpMM kernels of the port
// (bsr_spmm_flat.cu: flat block-CSR; bcsr_spmm_ell.cu: block-ELL;
// bsr_spmm_vres.cu takes the block constants, the short-block tile and the
// float32 arithmetic: ring::tf32_split, the rf:: MMAs and descriptors).
//
// One CTA (or warp) computes one output tile
//
//   out[r*BR : (r+1)*BR, d0 : d0+N] =
//       sum over the row's slots j (step s = j / G, group g = j % G) of
//       blocks[s][:, g*BC : (g+1)*BC] @ V[bcols[j]*BC : +BC, d0 : d0+N]
//
// where blocks[s] is a [BR, G*BC] slab (G dense blocks side by side).  A
// flat block-CSR row owns the slots of its consecutive steps
// row_ptr[r]..row_ptr[r+1]; a block-ELL row stored as [BR, maxblk*BC] is
// exactly one such step with G = maxblk.  The tile stays in registers for
// the walk and is written once: no atomics, no cross-CTA reduction,
// deterministic sums.  Element offsets are 64-bit (one million-link operand
// holds 1.55e9 elements).
//
// Two tile bodies, each for bfloat16 and for float32 blocks (T), one route
// of ops/bcsr.py::spmm_route each:
//   * ring_tile<T, N>: 128x128 blocks, one CTA per (block-row, D tile of up
//     to 128 columns), padding slots skipped, the blocks streamed through a
//     cp.async ring (design notes at the definitions below); bfloat16 with
//     mma.sync m16n8k16 (ring_tile_bf16, "ring"), float32 with three tf32
//     products per pair on wgmma m64nNk8 (ring_tile_f32, "ring_f32");
//   * short_tile<T, N, R, ELL>: blocks of every other shape, one warp per
//     item of merged block-rows (or slice of a tall one), the tile computed
//     transposed so that 8-row blocks fill the MMAs ("short_bf16",
//     "short_f32").
//
// Float32 blocks keep float32 accuracy on the tensor cores (3xTF32).  Each
// operand value x is split as hi = tf32(x), lo = tf32(x - hi) (rounded as
// cvt.rna: to nearest, ties away from zero, 10 explicit mantissa bits), and
// a product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: the dropped
// a_lo.b_lo and the rounding of each lo are below 2^-22 |a.b|, where one
// tf32 product (2^-11) would miss the kernels' 1e-5 check.  The MMAs of a
// few k8 steps (one in the short-block tile, a 32-deep stage in the ring
// tile) start from zero and their sum is added to the tile's float32 sums
// by an ordinary round-to-nearest add: the tensor core's own accumulation
// is not round-to-nearest, and chaining a whole row (48 MMAs a 128-deep
// block) through it let the error grow with the row (8e-7 of max|out|
// against 3e-7 on the 100k S-tilde, NVIDIA H100).  The blocks stay float32
// in memory (a split copy would double the bytes the kernels stream) and V
// is the caller's float32 array: both are split on the card, a block's
// values as their fragments are loaded, V's as its fragments are loaded in
// the short-block tile and once per stage into shared memory in the ring
// tile.  ops/bcsr.py::tf32_round and tf32_split_matmul model this
// arithmetic in plain torch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace spmm {

constexpr int BC = 128;   // block cols of the 128x128 paths

// ---------------------------------------------------------------------------
// 128x128 blocks on the tensor cores, streamed through a cp.async ring
// (ring_tile_bf16 here; ring_tile_f32 below shares the CTA, the walk and
// the ring).
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
// V: bfloat16 arrives rounded by the wrapper (the same round-to-nearest-even
// as the plain version), [nrows, ldv] with zero columns past D; float32 is
// the caller's [nrows, ldv >= D], whose columns past D are read as zeros
// (cp.async with a zero source size).  Both are gathered 16 bytes at a time.
//
// The ring: each stage holds one slice of a block, the 128 bytes of each of
// its 128 rows (A [128, 64] bfloat16 or [128, 32] float32, 16 KB) and the
// matching V rows [64 or 32, N], copied with cp.async.cg (16 B, L1
// bypassed) by all 256 threads.  Slice k+STAGES-1 is issued before the MMAs
// on slice k, across the row's slots, so STAGES-1 slices (16 KB of A each)
// are in flight while the tensor cores work; one barrier per slice.  Shared
// rows are padded by 16 bytes, so the ldmatrix row addresses of a warp fall
// in distinct banks.  MMAs are mma.sync m16n8k16 bf16 -> fp32 from
// ldmatrix (V with .trans); 8 warps tile [128, N] as WM x WN; the sums stay
// in registers and are stored once, float2 per thread, the D edge masked.
// ---------------------------------------------------------------------------
namespace ring {

constexpr int NT = 256;                  // 8 warps
constexpr int ROW = 128;                 // bytes of a block row in one stage
constexpr int PITCH = ROW + 16;          // bytes of a stage's A row (144)
constexpr int A_BYTES = 128 * PITCH;     // 18,432

// A stage in values of the block dtype.
template <typename T>
struct Elem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  static constexpr int CH = 16 / E;        // values in a 16-byte piece
  static constexpr int KS = ROW / E;       // contraction depth of a stage
  static constexpr int LDA = PITCH / E;    // pitch of an A row
};

template <int N>
struct Cfg {
  static_assert(N % 8 == 0 && N >= 8 && N <= 128, "N: 8..128, step 8");
  static constexpr int WN = N % 16 == 0 ? 2 : 1;   // warps across columns
  static constexpr int WM = 8 / WN;                // warps across rows
  static constexpr int MT = 128 / WM / 16;         // m16 tiles per warp
  static constexpr int NTL = N / WN / 8;           // n8 tiles per warp
  static constexpr int LDV = N + 8;                // pitch of a V row, values
  static constexpr int V_BYTES = ROW * LDV;        // KS rows, either dtype
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

// 16 bytes from src if `in`, else 16 zero bytes (nothing is read; src must
// still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
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

// x as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
// ties away from zero as cvt.rna.tf32.f32 rounds a finite value: half of
// the dropped 13 bits added to the magnitude bits (a carry moves into the
// exponent), the 13 bits then cleared; x - hi is exact in float32.  Integer
// operations, where cvt runs at a fraction of their rate.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d = a @ b + c on one m16n8k8 tile, tf32 inputs, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// acc += a @ b for float32 a, b given as tf32 halves (the header's 3xTF32):
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed from zero on the tensor core,
// then added to acc in float32.
__device__ __forceinline__ void mma3_tf32(float (&acc)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float p[4], q[4];
  mma_tf32(p, al, bh0, bh1, zero);
  mma_tf32(q, ah, bl0, bl1, p);
  mma_tf32(p, ah, bh0, bh1, q);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
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

// Issue the cp.async copies of slice `part` of slot j into ring stage `st`.
template <typename T, int N>
__device__ __forceinline__ void issue(uint32_t st, const int* __restrict__ bcols,
                                      const T* __restrict__ blocks,
                                      const T* __restrict__ V, int ldv,
                                      int64_t j, int part, int G, int D,
                                      int d0) {
  using C = Cfg<N>;
  using X = Elem<T>;
  const int tid = threadIdx.x;
  const int64_t s = j / G;
  const int64_t ld = (int64_t)G * BC;
  const T* a = blocks + s * 128 * ld + (j - s * G) * BC + part * X::KS;
  // A slice [128, KS]: 1,024 pieces of 16 bytes, 4 per thread.
#pragma unroll
  for (int e = 0; e < 128 * (ROW / 16) / NT; ++e) {
    const int idx = e * NT + tid;
    const int i = idx / (ROW / 16), c = idx % (ROW / 16);
    cp_async16(st + i * PITCH + c * 16, a + i * ld + c * X::CH);
  }
  // V rows [KS, N] of the slot's column-block.
  const T* v = V + ((int64_t)__ldg(bcols + j) * BC + part * X::KS) * ldv + d0;
  const uint32_t vs = st + A_BYTES;
  constexpr int PIECES = X::KS * N / X::CH;
#pragma unroll
  for (int e = 0; e < (PIECES + NT - 1) / NT; ++e) {
    const int idx = e * NT + tid;
    if (PIECES % NT == 0 || idx < PIECES) {
      const int k = idx / (N / X::CH), c = idx % (N / X::CH);
      const uint32_t dst = vs + (k * C::LDV + c * X::CH) * X::E;
      const T* row = v + (int64_t)k * ldv;
      if constexpr (X::F32) {
        const bool in = d0 + c * X::CH < D;
        cp_async16_zfill(dst, in ? row + c * X::CH : row, in);
      } else {
        cp_async16(dst, row + c * X::CH);
      }
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
  constexpr int LDA = ring::Elem<__nv_bfloat16>::LDA;
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
      ring::issue<__nv_bfloat16, N>(base + stage * C::STAGE, bcols, blocks,
                                    Vb, ldv, jp, hp, G, D, d0);
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
    for (int kk = 0; kk < ring::Elem<__nv_bfloat16>::KS; kk += 16) {
      uint32_t af[C::MT][4];
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
        ring::ldsm_x4(af[m], as + ((row0 + m * 16 + lr) * LDA + kk + lc) * 2);
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

// ---------------------------------------------------------------------------
// 128x128 float32 blocks on wgmma (ring_tile_f32).
//
// The CTA, its slot walk, the padding rule and the cp.async ring are the
// bfloat16 ring's (above): each stage holds a [128, 32] float32 slice of a
// block (rows padded to 144 bytes) and the matching V rows [32, N] (columns
// past D zero-filled).  The products run on wgmma: with mma.sync, three
// tf32 products per pair made this tile MMA-bound from D = 48 on (0.61 ms
// at D = 128 on the 100k S-tilde, 0.25 ms with one product; NVIDIA H100).
// Two warpgroups each take 64 rows and all N columns as m64nNk8 MMAs:
//   * A comes from registers: each warp loads its 16 rows of a k8 step by
//     ldmatrix (an 8x8 matrix of 16-bit values is 8 rows of 4 floats; the
//     fragment is mma.m16n8k8's) and splits it into tf32 halves there;
//   * B must lie in shared memory K-major for tf32, while V's rows arrive
//     N-contiguous: the CTA reads a stage's [32, N] slice of V, splits each
//     value and writes the halves transposed into a buffer of no-swizzle
//     core matrices (8 rows of n by 16 bytes of k; for a k8 step, core
//     matrix (n/8, k/4) at byte 128 * (2 * (n/8) + k/4)), then fences the
//     async proxy.  There are two such buffers: slice t+1 is split while
//     slice t's MMAs run;
//   * each k8 step is three MMAs, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; the
//     stage's twelve chain into sums that start from zero (scale-d 0) and
//     are added to the tile's float32 sums once the group completes, so
//     the tensor core's own accumulation spans 32 of a row's products.
// Two barriers per stage.  The stage's sums double the registers: up to
// N = 48 two CTAs share an SM; from 64 on one, with a deeper ring (two
// spilled at 64 and do not fit at 96 and 128).
// ---------------------------------------------------------------------------
namespace rf {

template <int N>
struct Cfg {
  using R = ring::Cfg<N>;
  static constexpr int LDV = R::LDV;
  static constexpr int STAGE = R::STAGE;        // A and V as the bf16 ring's
  static constexpr int B_STEP = 32 * N;         // one k8 step of B, bytes
  static constexpr int B_BUF = 8 * B_STEP;      // halves of a stage's 4 steps
  static constexpr int B_BYTES = 2 * B_BUF;     // two stages' B
  static constexpr int CTAS = N <= 48 ? 2 : 1;  // CTAs per SM
  // As many stages as fit (at most 6), at least 3: an SM has 233,472
  // bytes of shared memory, 1,024 of them held back per CTA.
  static constexpr int FIT = (233472 / CTAS - 1024 - B_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static_assert(STAGES >= 3, "the f32 ring needs three stages");
  static constexpr int SMEM = B_BYTES + STAGES * STAGE;
};

// wgmma shared-memory matrix descriptor, no swizzle: LBO the byte offset
// between core matrices adjacent in K, SBO between those adjacent in N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F8(i) F4(i), F4(i + 4)

// d (+)= a @ B on one m64nNk8 tile: A's fragment in registers (tf32), B
// K-major in shared memory; scale_d = 0 overwrites d.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<8> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3"
        "}, {%4,%5,%6,%7}, %8, p, 1, 1;\n}\n"
        : F4(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7"
        "}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
        : F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
        "}, {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
        : F8(0), F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<48> {
  static __device__ __forceinline__ void mma(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23"
        "}, {%24,%25,%26,%27}, %28, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
        "}, {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

#undef F8
#undef F4

// wgmma descriptor of a K-major operand in 128-byte swizzle: rows of 128
// bytes (32 tf32 values of k), 16-byte piece p of row n stored at piece
// p ^ (n % 8), 8-row groups 1,024 bytes apart; a k8 step moves the start
// 32 bytes along the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return desc(addr, 16, 1024) | (1ull << 62);
}

// The twelve MMAs of a 32-deep stage (the header's 3xTF32): p = the sum over
// its four k8 steps of a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, chained from zero
// (scale-d 0 on the first), A's halves in registers (ah, al: the warp's
// m16n8k8 fragments of each step), B's hi halves at bhi and its lo halves
// 128*N bytes after, K-major: in no-swizzle core matrices (SW128 false:
// the k8 step ks at 32*N*ks bytes, core matrix (n/8, (k%8)/4) at 128 * (2 *
// (n/8) + (k%8)/4) bytes in it, ring_tile_f32's split_v) or in rows of 128
// bytes with 128-byte swizzle (SW128 true, desc_sw128).
template <int N, bool SW128 = false>
__device__ __forceinline__ void stage_mma(float (&p)[N / 2],
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4],
                                          uint32_t bhi) {
  constexpr uint32_t STEP = SW128 ? 32 : 32 * N, LO = 128 * N;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t h = bhi + ks * STEP;
    const uint64_t dh = SW128 ? desc_sw128(h) : desc(h, 128, 256);
    const uint64_t dl = SW128 ? desc_sw128(h + LO) : desc(h + LO, 128, 256);
    WgmmaTf32<N>::mma(p, al[ks], dh, ks > 0);
    WgmmaTf32<N>::mma(p, ah[ks], dl, 1);
    WgmmaTf32<N>::mma(p, ah[ks], dh, 1);
  }
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

}  // namespace rf

template <int N>
__device__ __forceinline__ void ring_tile_f32(
    const int* __restrict__ bcols, const float* __restrict__ blocks,
    const float* __restrict__ V, int ldv, float* __restrict__ out, int64_t j0,
    int64_t j1, int G, int D, int64_t r, int d0, unsigned char* smem) {
  using C = rf::Cfg<N>;
  constexpr int S = C::STAGES;
  constexpr int LDA = ring::Elem<float>::LDA;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  // This lane's ldmatrix row address: row (lane%8) + 8*((lane/8)%2) of the
  // warp's 16, floats 4*(lane/16) .. +4 of the k8 step.
  const int arow = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 4;
  const uint32_t bbase = ring::smem_addr(smem);
  const uint32_t base = bbase + C::B_BYTES;
  uint32_t* const bwords = reinterpret_cast<uint32_t*>(smem);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  int64_t jp = j0;
  int hp = 0;
  int issued = 0;
  auto produce = [&](int stage) {
    if (jp < j1) {
      ring::issue<float, N>(base + stage * C::STAGE, bcols, blocks, V, ldv,
                            jp, hp, G, D, d0);
      ++issued;
      if (++hp == BC / ring::Elem<float>::KS) {
        hp = 0;
        jp = ring::next_real(bcols, jp, j1);
      }
    }
    ring::cp_async_commit();   // possibly empty: keeps the group count fixed
  };
  // B of slice t: V[k][n] of its stage, k = 8*ks + 4*h + kk, n = 8*j + rr,
  // split, the halves at word u = 32*cm + 4*rr + kk of buffer t%2's hi and
  // lo parts, cm = ks*N/4 + 2*j + h (a warp writes one core matrix; its
  // reads fall in distinct banks, LDV = 8 or 24 mod 32), then the async
  // proxy fenced (wgmma reads it).
  auto split_v = [&](int t) {
    const float* vf = reinterpret_cast<const float*>(
        smem + C::B_BYTES + (t % S) * C::STAGE + ring::A_BYTES);
    uint32_t* const hi = bwords + (t % 2) * (C::B_BUF / 4);
#pragma unroll
    for (int e = 0; e < N / 8; ++e) {
      const int u = e * ring::NT + tid;
      const int cm = u >> 5, ks = cm / (N / 4), jh = cm % (N / 4);
      const int k = ks * 8 + (jh & 1) * 4 + (u & 3);
      const int n = (jh >> 1) * 8 + ((u >> 2) & 7);
      uint32_t h, l;
      ring::tf32_split(vf[k * C::LDV + n], h, l);
      hi[u] = h;
      hi[C::B_BUF / 8 + u] = l;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) produce(st);
  if (issued > 0) {
    ring::cp_async_wait<S - 2>();   // slice 0 has landed (this thread's part)
    __syncthreads();                // ... everyone's
    split_v(0);
  }

  // Slice t: its B was split in the step before; its MMAs run while the
  // CTA splits slice t+1 into the other buffer.
  for (int t = 0; t < issued; ++t) {
    __syncthreads();   // slice t's B is complete
    const uint32_t as = base + (t % S) * C::STAGE;
    // A: this warp's 16 rows of the four k8 steps, split.
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      ring::ldsm_x4(a, as + (arow * LDA + ks * 8 + acol) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ring::tf32_split(__uint_as_float(a[e]), ah[ks][e], al[ks][e]);
    }
    float p[N / 2];
    rf::fence_regs<4>(ah);
    rf::fence_regs<4>(al);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    rf::stage_mma<N>(p, ah, al, bbase + (t % 2) * C::B_BUF);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (t + 1 < issued) {
      ring::cp_async_wait<S - 3>();   // slice t+1 has landed (this thread)
      // ... everyone's; every thread has read slice t's A and waited for
      // slice t-1's MMAs, so its stage and the other B buffer are free.
      __syncthreads();
      produce((t + S - 1) % S);
      split_v(t + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    rf::fence_regs<N / 2>(p);
    rf::fence_regs<4>(ah);
    rf::fence_regs<4>(al);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += p[i];
  }

  // Sum i of this thread: row 16*warp + lane/4 + 8*((i/2)%2) of the
  // warpgroup's 64, column 8*(i/4) + 2*(lane%4) + i%2.
  const int64_t row = r * 128 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const int d = d0 + 8 * c + 2 * (lane % 4);
    if (d < D) {   // D even: columns d and d+1 are both in
      *reinterpret_cast<float2*>(&out[row * D + d]) =
          make_float2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<float2*>(&out[(row + 8) * D + d]) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// The ring tile of dtype T, its CTAs per SM and shared memory.
template <typename T, int N>
__device__ __forceinline__ void ring_tile(
    const int* __restrict__ bcols, const T* __restrict__ blocks,
    const T* __restrict__ V, int ldv, float* __restrict__ out, int64_t j0,
    int64_t j1, int G, int D, int64_t r, int d0, unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value)
    ring_tile_f32<N>(bcols, blocks, V, ldv, out, j0, j1, G, D, r, d0, smem);
  else
    ring_tile_bf16<N>(bcols, blocks, V, ldv, out, j0, j1, G, D, r, d0, smem);
}

template <typename T, int N>
struct RingLaunch {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int CTAS = F32 ? rf::Cfg<N>::CTAS : 2;
  static constexpr int SMEM = F32 ? rf::Cfg<N>::SMEM : ring::Cfg<N>::SMEM;
};

// Output columns one ring CTA may cover (the instantiated N).
#define SPMM_RING_COLS(X) X(8) X(16) X(32) X(48) X(64) X(96) X(128)

// V's pitch for an N-column tile over D columns: bfloat16 V comes padded
// with zero columns to whole tiles (ldv >= ceil(D / N) * N); float32 V is
// the caller's array, read up to column D.
template <typename T>
inline bool v_pitch_ok(int ldv, int D, int N) {
  if (std::is_same<T, float>::value) return ldv >= D;
  return ldv >= (D + N - 1) / N * N;
}

// ---------------------------------------------------------------------------
// Blocks of every shape but 128x128 on the tensor cores (short_tile): the
// body of 8x128 (the packers' default), 8x8, 16x16, the mid-K search's
// 32x32, blocks taller than 128 rows, Bc not a multiple of the MMA depth,
// ..., with Br and Bc given at run time; bfloat16 ("short_bf16") and
// float32 ("short_f32") blocks.
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
//     each 8-row block alone would pull 12 KB of V (Bc = 128, D = 48,
//     bfloat16) for its 2 KB;
//   * a taller block-row is cut into RW-row slices, each an item.
// The tile is computed transposed,
//
//   out[rows, cols]^T  =  V[k, cols]^T  .  A[rows, k]^T,
//
// with mma.sync, fp32 sums (m16n8k16 for bfloat16; for float32 three
// m16n8k8 tf32 MMAs per step, the header's 3xTF32): M is D (N/16 m16
// tiles), N is the item's rows (NTW n8 tiles: an 8-row block fills one,
// where the ring tile's orientation, m16 over rows, would leave half of
// every MMA empty), K is Bc.  The A operand is V as it lies in shared
// memory, rows k with D contiguous (bfloat16 through ldmatrix.trans,
// float32 by plain shared loads); the B operand is the blocks' rows as
// stored, k contiguous, through plain ldmatrix (for float32 an 8x8 matrix
// of 16-bit values is 8 rows of 4 floats).
//
// The warps are persistent: the grid holds as many CTAs of W = 4 warps as
// fit on the card at once, and warp w takes items w, w + T, w + 2T, ...
// (T warps in all, the D tiles of an item's rows adjacent), so the four
// warps of a CTA hold neighbouring block-rows at a time, no wave is left
// half empty and the work is fixed by the launch, not by a counter.  Each
// warp streams slices of 64 bytes of depth (its blocks' rows [*, k0 :
// k0+KS] and V rows [k0, k0+KS] of the column-block, columns d0 .. d0+N;
// KS = 32 bfloat16 or 16 float32 values) through its own ring of STAGES
// slices in shared memory with cp.async, 16 bytes at a time, STAGES-1
// slices in flight while the tensor cores work, across the end of one item
// into the next; warps share nothing and never meet at a CTA-wide barrier
// (__syncwarp only).  A slice past Bc is zero-filled in shared memory up to
// the next multiple of the MMA depth (bfloat16 Bc = 40: the last slice is 8
// deep, padded to 16); a Bc whose rows do not start on 16 bytes copies the
// blocks a value at a time.  bfloat16 V is rounded once by the wrapper (the
// plain version's round-to-nearest-even) and padded to whole tiles; float32
// V is the caller's, its columns past D read as zeros; both bypass L1.
// Shared rows are padded by 16 bytes so the eight row addresses of an
// ldmatrix fall in distinct banks, and a V row's pitch of N + 8 values puts
// a float32 fragment's four rows in distinct banks.  Padding slots are
// skipped by ring::next_real's rule, read from a window of eight slots per
// merged row that the warp's lanes hold, so the slot indices cost one load
// per eight slots.  Sums stay in fp32 registers and each item is stored
// once: no atomics, two launches bitwise equal.  Element offsets are
// 64-bit; slot indices 32-bit (an operand has fewer than 2^31 slots, which
// the wrappers check).
// ---------------------------------------------------------------------------
namespace sb {

// SPMM_SHORT_NO_MMA drops the tensor-core work, so that
// experiments/bench_short_parts.py can time the loads alone (its result is
// wrong).
constexpr int W = 4;              // warps per CTA
constexpr int NT = W * 32;
constexpr int ROW = 64;           // bytes of a block row in one slice
constexpr int PITCH = ROW + 16;   // bytes of a slice's block row (80)
constexpr int RMAX = 4;           // block-rows merged into one item, at most

// A slice in values of the block dtype.
template <typename T>
struct Elem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  static constexpr int CH = 16 / E;        // values in a 16-byte piece
  static constexpr int KS = ROW / E;       // contraction depth of a slice
  static constexpr int MK = F32 ? 8 : 16;  // depth of one MMA
};

template <int N>
struct Cfg {
  static_assert(N % 16 == 0 && N >= 16 && N <= 128, "N: 16..128, step 16");
  static constexpr int MT = N / 16;             // m16 tiles over D
  static constexpr int NTW = N <= 64 ? 4 : 2;   // n8 tiles: 64 fp32 sums at most
  static constexpr int RW = 8 * NTW;            // output rows of an item
  static constexpr int LDV = N + 8;             // pitch of a V row, values
  static constexpr int A_BYTES = RW * PITCH;
  static constexpr int V_BYTES = ROW * LDV;     // KS rows, either dtype
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
// a template parameter so that a short merge keeps fewer registers.  V is
// [nrows, ldv] in the block dtype.
template <typename T, int N, int RMAX, bool ELL>
__global__ void __launch_bounds__(sb::NT)
short_tile(const int* __restrict__ row_ptr, const int* __restrict__ bcols,
           const T* __restrict__ blocks, const T* __restrict__ Vb, int ldv,
           float* __restrict__ out, sb::Geom g) {
  using C = sb::Cfg<N>;
  using X = sb::Elem<T>;
  constexpr int S = C::STAGES;
  constexpr int KS = X::KS, CH = X::CH, MK = X::MK;
  static_assert(RMAX == 1 || RMAX == 2 || RMAX == 4, "merge: 1, 2 or 4");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* const wsmem = smem + warp * C::WARP_SMEM;
  const uint32_t base = ring::smem_addr(wsmem);
  const ShortWalk<N, ELL> walk{row_ptr, g, (int64_t)gridDim.x * sb::W};
  const int64_t first = (int64_t)blockIdx.x * sb::W + warp;
  const int64_t ld = (int64_t)g.G * g.Bc;   // row stride inside a slab
  const bool aligned = g.Bc % CH == 0;      // every block piece on 16 bytes

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
  // Per stage, four bits: MMA depth steps (bits 0-1) and the item's end
  // (bit 3).
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
      const int kn = min(KS, g.Bc - kq);           // real depth of the slice
      const int kp = (kn + MK - 1) & ~(MK - 1);    // depth the MMAs read
      const uint32_t st = base + stage * C::STAGE;
      // Block rows: q's rows at shared rows q*rq .., zeros for a merged
      // row without this column-block.
#pragma unroll
      for (int q = 0; q < RMAX; ++q) {
        if (q >= pu.nrow) break;
        const bool has = (pmask >> q) & 1;
        const T* a = blocks + pa[q] + kq;
        for (int idx = lane; idx < pu.rq * (KS / CH); idx += 32) {
          const int i = idx / (KS / CH), c = (idx % (KS / CH)) * CH;
          if (c >= kp) continue;
          const uint32_t dst = st + (q * pu.rq + i) * sb::PITCH + c * X::E;
          const T* src = a + i * ld + c;
          if (!has || c >= kn) {
            sb::st_shared_zero16(dst);
          } else if (aligned && c + CH <= kn) {
            ring::cp_async16(dst, src);
          } else {
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (X::F32) {
                w[e] = c + e < kn ? __float_as_uint(src[e]) : 0u;
              } else {
                const uint16_t lo = c + 2 * e < kn
                    ? __bfloat16_as_ushort(src[2 * e]) : (uint16_t)0;
                const uint16_t hi = c + 2 * e + 1 < kn
                    ? __bfloat16_as_ushort(src[2 * e + 1]) : (uint16_t)0;
                w[e] = (uint32_t)lo | ((uint32_t)hi << 16);
              }
            }
            sb::st_shared16(dst, w[0], w[1], w[2], w[3]);
          }
        }
      }
      // V rows [kq, kq + kp) of column-block pcol, columns d0 .. d0+N.
      const T* v = Vb + ((int64_t)pcol * g.Bc + kq) * ldv + pd0;
      const uint32_t vs = st + C::A_BYTES;
      for (int idx = lane; idx < kp * (N / CH); idx += 32) {
        const int k = idx / (N / CH), c = (idx % (N / CH)) * CH;
        const uint32_t dst = vs + (k * C::LDV + c) * X::E;
        if (k < kn) {
          const T* row = v + (int64_t)k * ldv;
          if constexpr (X::F32) {   // the caller's V: past D read as zeros
            const bool in = pd0 + c < g.D;
            ring::cp_async16_zfill(dst, in ? row + c : row, in);
          } else {
            ring::cp_async16(dst, row + c);
          }
        } else {
          sb::st_shared_zero16(dst);
        }
      }
      uint32_t meta = (uint32_t)(kp / MK);
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
  // row lane%8 at byte 16*(lane/8), so one x4 load holds two MMA steps of
  // one n8 tile; bfloat16 A (V rows, D contiguous, transposed) takes V row
  // (lane%8) + 8*(lane/16) at column 8*((lane/8)%2).  Float32 A fragments
  // are V[q][g], V[q][g+8], V[q+4][g], V[q+4][g+8] of the m16 tile.
  const int brow = lane & 7, bbyte = (lane >> 3) * 16;
  const int vrow = (lane & 7) + (lane >> 4) * 8, vcol = ((lane >> 3) & 1) * 8;
  const int gq = lane >> 2, q2 = (lane & 3) * 2, qk = lane & 3;

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
        ring::ldsm_x4(bf[n], as + (n * 8 + brow) * sb::PITCH + bbyte);
#pragma unroll
    for (int ks = 0; ks < KS / MK; ++ks) {
      if (ks < ksteps) {
        if constexpr (X::F32) {
          uint32_t bh[C::NTW][2], bl[C::NTW][2];
#pragma unroll
          for (int n = 0; n < C::NTW; ++n)
            if (n < ntv)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                ring::tf32_split(__uint_as_float(bf[n][2 * ks + e]), bh[n][e],
                                 bl[n][e]);
          const float* vf = reinterpret_cast<const float*>(
              wsmem + (t % S) * C::STAGE + C::A_BYTES) +
              (ks * 8 + qk) * C::LDV + gq;
#pragma unroll
          for (int m = 0; m < C::MT; ++m) {
            const float* v = vf + m * 16;
            const float a[4] = {v[0], v[8], v[4 * C::LDV], v[4 * C::LDV + 8]};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) ring::tf32_split(a[e], ah[e], al[e]);
#ifndef SPMM_SHORT_NO_MMA
#pragma unroll
            for (int n = 0; n < C::NTW; ++n)
              if (n < ntv)
                ring::mma3_tf32(acc[m][n], ah, al, bh[n][0], bh[n][1],
                                bl[n][0], bl[n][1]);
#endif
          }
        } else {
#pragma unroll
          for (int m = 0; m < C::MT; ++m) {
            uint32_t af[4];
            ring::ldsm_x4_t(af, vs + ((ks * 16 + vrow) * C::LDV + m * 16 +
                                      vcol) * 2);
#ifndef SPMM_SHORT_NO_MMA
#pragma unroll
            for (int n = 0; n < C::NTW; ++n)
              if (n < ntv)
                ring::mma_bf16(acc[m][n], af, bf[n][2 * ks],
                               bf[n][2 * ks + 1]);
#endif
          }
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

// Blocks Br x Bc through short_tile<T, N, R>: V [nrows, ldv] in the block
// dtype (v_pitch_ok), out [nrows, D] float32.  ELL: block-row r is one step
// of G = maxblk slots (row_ptr unused); else flat block-CSR, the row's
// steps row_ptr[r] .. row_ptr[r+1].  The grid is the CTAs that fit on the
// card at once (no more than the items need).
template <typename T, int N, int R, bool ELL>
inline int launch_short_r(const int* row_ptr, const int* bcols,
                          const T* blocks, int Br, int Bc, const T* V,
                          int ldv, float* out, long long Kbr, int G, int D,
                          cudaStream_t st) {
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
  if (!v_pitch_ok<T>(ldv, D, N) || (ELL && Kbr * G > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  auto kernel = short_tile<T, N, R, ELL>;
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
  kernel<<<(unsigned)grid, sb::NT, C::SMEM, st>>>(row_ptr, bcols, blocks, V,
                                                  ldv, out, g);
  return (int)cudaGetLastError();
}

// The merge for Br: as many block-rows as fill the item's RW rows (4, 2 or
// 1, at most sb::RMAX), one for a block-row taller than RW.
template <typename T, int N, bool ELL>
inline int launch_short_n(const int* row_ptr, const int* bcols,
                          const T* blocks, int Br, int Bc, const T* V, int ldv,
                          float* out, long long Kbr, int G, int D,
                          cudaStream_t st) {
  const int fit = Br <= sb::Cfg<N>::RW ? sb::Cfg<N>::RW / Br : 1;
  const int r = fit < sb::RMAX ? fit : sb::RMAX;
  if constexpr (sb::Cfg<N>::RW >= 32) {
    if (r >= 4)
      return launch_short_r<T, N, 4, ELL>(row_ptr, bcols, blocks, Br, Bc, V,
                                          ldv, out, Kbr, G, D, st);
  }
  if (r >= 2)
    return launch_short_r<T, N, 2, ELL>(row_ptr, bcols, blocks, Br, Bc, V,
                                        ldv, out, Kbr, G, D, st);
  return launch_short_r<T, N, 1, ELL>(row_ptr, bcols, blocks, Br, Bc, V, ldv,
                                      out, Kbr, G, D, st);
}

// Output columns one warp of the short-block tile may cover (the
// instantiated N).
#define SPMM_SHORT_COLS(X) X(16) X(32) X(48) X(64) X(96) X(128)

// Blocks Br x Bc of dtype T through the short-block tile, ncols one of
// SPMM_SHORT_COLS (see launch_short_n).  Returns the cudaError_t of the
// launch.
template <typename T, bool ELL>
inline int launch_short(const void* row_ptr, const void* bcols,
                        const void* blocks, int Br, int Bc, const void* V,
                        int ldv, void* out, long long Kbr, int G, int D,
                        int ncols, cudaStream_t st) {
  if (Kbr <= 0 || G <= 0 || Br <= 0 || Bc <= 0 || D <= 0 || D % 8 != 0 ||
      ldv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const T* a = static_cast<const T*>(blocks);
  const T* v = static_cast<const T*>(V);
  float* o = static_cast<float*>(out);
  switch (ncols) {
#define SPMM_CASE(N)                                                        \
  case N:                                                                   \
    return launch_short_n<T, N, ELL>(rp, bc, a, Br, Bc, v, ldv, o, Kbr, G, \
                                     D, st);
    SPMM_SHORT_COLS(SPMM_CASE)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace spmm
