// Flat block-CSR SpMM with V held resident for Hopper: out = A @ V, A stored
// as only its real blocks, G per step (128x128; other shapes through the
// flat kernel's short-block tile).
//
// Replaces the TPU kernel sig_sdp_mmw_tpu/ops/bcsr.py::bsr_spmm_pallas_vres:
// the contract of bsr_spmm_pallas_flat (V cast to the block dtype once,
// products summed in float32, every output row-block written once and in
// full) with all of V resident on chip, so that only the blocks stream from
// device memory.
//
// What "resident V" means on this card.  No SM holds all of V (9.6 MB of
// bf16 at K=100,467 and D=48, 25.7 MB at D=128), but the 50 MB L2 does.
// The wrapper casts V to the block dtype once (as the TPU kernel does) and
// passes that copy here; then
//   * bf16: the TMA loads of V carry an evict_last cache hint and those of
//     the blocks evict_first, so the streamed blocks leave L2 before V.  A
//     persisting access-policy window over V as well (VRES_L2_WINDOW) was
//     no faster at D=48 and 1.5-1.9x slower at D=128 on an H100
//     (experiments/bench_vres_parts.py), so it is not shipped;
//   * float32: the launch gives the copy an L2 access-policy window with
//     hitProp persisting (missProp streaming), as a launch attribute: it
//     holds for this launch only and no later kernel runs under it.  The
//     persisting set-aside is raised to the copy's size (at most the device
//     maximum) for the launch and put back to its previous size right
//     after, since a set-aside left in place slows every later kernel (see
//     the note at the end of launch_resident).
// What bounds it: the real blocks' bytes from device memory (0.19 GB at
// K=100,467, against 0.03-0.08 GB of V and out), so the design keeps block
// loads in flight at all times and reads nothing it does not need.
//
// bfloat16 blocks (bsr_spmm_vres_tma<N>), one persistent CTA per SM:
//   * work items are (block-row, 128-column tile of D) in index order; a
//     CTA takes the next item from a counter the launch zeroes, so a CTA
//     that drew short rows takes more of them.  Taking the rows longest
//     first instead was no faster on an H100 at D=48 and 7% slower at
//     D=128 (device time, experiments/bench_vres_parts.py);
//   * one producer warp walks the item's slots, skips padding by the rule of
//     ring::next_real (spmm_tile.cuh: a slot after the row's first whose
//     column-block is 0 holds zeros), and for each real slot issues TMA
//     loads into a ring stage: the block as two [128, 64] boxes of the
//     [nsteps*128, G*128] block array, and the V rows of its column-block,
//     [128, N], as boxes of one swizzle atom's width from the [Kp, ldv]
//     bf16 copy (columns past ldv come in as zeros).  Full/empty mbarriers
//     per stage; the stage's item and first/last flags travel beside it in
//     shared memory, so the ring runs across row boundaries and the next
//     row's loads are in flight during a row's epilogue;
//   * two consumer warpgroups cover the 128 rows as m64 each with
//     wgmma.m64nNk16 bf16 -> fp32: A K-major in 128-byte swizzle, V MN-major
//     (N contiguous, the B transpose bit) in the swizzle of its atom (128 B
//     at N >= 64, 64 B at N=32, 32 B at N=16).  N is ldv rounded up to
//     16, 32, 64 or 128; above 128 columns an item is one 128-column tile.
//     Sums stay in registers; the row's last block is followed by stores of
//     whole 32-byte sectors straight from the accumulator layout.
// Float32 blocks (bsr_spmm_vres_f32), off every main path, keep a simple
// design: one CTA per (block-row, 64-column D tile) on a one-dimensional
// grid, the V column-blocks of a step stacked in shared memory, fp32 FMA
// (full float32, no TF32).  Block shapes other than 128x128 go through the
// flat kernel's short-block tile (spmm_tile.cuh), bfloat16
// (bsr_spmm_vres_short_launch) or float32 (bsr_spmm_vres_short_f32_launch);
// V stays in device memory and L2 without a residency hint.
//
// Variants of the bf16 path for experiments/bench_vres_parts.py (-D at
// build time): VRES_STAGES=n ring depth; VRES_ONE_ITEM_PER_CTA one CTA per
// item (no persistence); VRES_NO_CACHE_HINTS plain TMA loads;
// VRES_L2_WINDOW the float32 path's persisting window over V as well.
//
// Operands (all device pointers, contiguous):
//   row_ptr [Kbr+1] int32, bcols [nsteps*G] int32  as in bsr_spmm_flat.cu
//   blocks  [nsteps, 128, G*128] float32 or bfloat16
//   Vc     [nrows, ldv] in the block dtype, ldv a multiple of 8
//   out     [nrows, D] float32 (written in full), D <= ldv a multiple of 8

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the
                    // driver at run time (no -lcuda)

#include "spmm_tile.cuh"

namespace {

using spmm::BC;
constexpr int DT = 64;   // output columns per CTA of the float32 path
constexpr int KC = 32;   // contraction slice it stages per pass

// ---------------------------------------------------------------------------
// bfloat16 blocks: TMA ring, wgmma, persistent CTAs
// ---------------------------------------------------------------------------
namespace tma {

constexpr int CONSUMERS = 256;           // two warpgroups, m64 each
constexpr int NT = CONSUMERS + 32;       // + one producer warp
constexpr int A_BYTES = 128 * BC * 2;    // one block, two [128, 64] boxes
constexpr int A_HALF = A_BYTES / 2;
constexpr int FIRST = 1, LAST = 2, DONE = 4;   // stage flags

template <int N>
struct Cfg {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N: 16..128");
  static constexpr int W = N < 64 ? N : 64;         // V box width, one atom
  static constexpr int NBOX = N / W;
  static constexpr int V_BOX = BC * W * 2;          // bytes of one V box
  static constexpr int STAGE = A_BYTES + N * BC * 2;
#ifdef VRES_STAGES
  static constexpr int STAGES = VRES_STAGES;
#else
  // About 200 KB of ring: one CTA per SM.
  static constexpr int STAGES = N == 128 ? 3 : N == 64 ? 4 : N == 32 ? 5 : 6;
#endif
  static_assert(STAGES >= 2, "the ring needs two stages");
  // Ring (1024-aligned for the 128-byte swizzle), then full and empty
  // barriers and each stage's item record.
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 8 + 8 + 16);
  // wgmma descriptor of V, MN-major: layout type (1 = 128 B, 2 = 64 B,
  // 3 = 32 B swizzle), byte offset between 8-row K groups (SBO) and between
  // atoms along N (LBO), and the advance of one k16 step.
  static constexpr uint64_t V_LAYOUT = W == 64 ? 1 : W == 32 ? 2 : 3;
  static constexpr uint32_t V_SBO = 8 * W * 2;
  static constexpr uint32_t V_LBO = V_BOX;
  static constexpr uint32_t V_KSTEP = 16 * W * 2;
  static constexpr CUtensorMapSwizzle V_SWIZZLE =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Waits for the phase of parity `parity` to complete.  A wait of more than
// 2^35 cycles (some 20 s) can only be a broken ring: it traps, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into shared dst, its bytes
// reported to bar.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar,
                                         uint64_t policy) {
#ifdef VRES_NO_CACHE_HINTS
  (void)policy;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
#else
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "l"(policy)
      : "memory");
#endif
}

// wgmma shared-memory matrix descriptor.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

#define F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A @ B on one m64nNk16 tile: A K-major, B MN-major (trans-b = 1);
// scale_d = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7"
        "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : F8(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : F8(0), F8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef F8

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace tma

template <int N>
__global__ void __launch_bounds__(tma::NT, 1)
bsr_spmm_vres_tma(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const int* __restrict__ row_ptr,
                  const int* __restrict__ bcols, int* __restrict__ counter,
                  float* __restrict__ out, int G, int D, int nct, int items) {
  using C = tma::Cfg<N>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tma::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* top = smem_raw + (ring - raw) + S * C::STAGE;
  const uint32_t full = tma::smem_u32(top);       // S barriers of 8 bytes
  const uint32_t empty = full + 8 * S;
  int4* meta = reinterpret_cast<int4*>(top + 16 * S);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      tma::bar_init(full + 8 * s, 1);    // the producer's arrival + bytes
      tma::bar_init(empty + 8 * s, tma::CONSUMERS / 32);   // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= tma::CONSUMERS) {
    // ---- producer warp --------------------------------------------------
    const int lane = tid % 32;
    const uint64_t pol_a = tma::policy_evict_first();
    const uint64_t pol_v = tma::policy_evict_last();
    int stage = 0;
    uint32_t phase = 1;   // a fresh barrier passes a wait on parity 1
    auto next_stage = [&]() {
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    };
    int item = 0;
#ifdef VRES_ONE_ITEM_PER_CTA
    item = blockIdx.x;
#else
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
#endif
    while (item < items) {
#ifndef VRES_ONE_ITEM_PER_CTA
      int nxt = items;
      if (lane == 0) nxt = atomicAdd(counter, 1);   // used after this item
#endif
      const int r = item / nct;
      const int ct = item % nct;
      const int64_t j0 = (int64_t)__ldg(row_ptr + r) * G;
      const int64_t j1 = (int64_t)__ldg(row_ptr + r + 1) * G;
      // The row's last real slot, 32 slots at a time from the end.
      int64_t last = j0;
      for (int64_t hi = j1; hi > j0; hi -= 32) {
        const int64_t j = hi - 32 + lane;
        const bool real = j >= j0 && (j == j0 || __ldg(bcols + j) != 0);
        const unsigned m = __ballot_sync(0xffffffffu, real);
        if (m) {
          last = hi - 32 + (31 - __clz(m));
          break;
        }
      }
      for (int64_t lo = j0; lo <= last; lo += 32) {
        const int64_t j = lo + lane;
        const int bc = j <= last ? __ldg(bcols + j) : 0;
        unsigned m = __ballot_sync(0xffffffffu,
                                   j <= last && (j == j0 || bc != 0));
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          const int bcb = __shfl_sync(0xffffffffu, bc, b);
          const int64_t jj = lo + b;
          if (lane == 0) {
            tma::bar_wait(empty + 8 * stage, phase);
            meta[stage] = make_int4(r, ct,
                                    (jj == j0 ? tma::FIRST : 0) |
                                        (jj == last ? tma::LAST : 0),
                                    0);
            const uint32_t fb = full + 8 * stage;
            tma::bar_expect(fb, C::STAGE);
            const uint32_t dst = ring + stage * C::STAGE;
            const int64_t s = jj / G;
            const int g = (int)(jj - s * G);
            tma::load_box(dst, &a_map, g * BC, (int)(s * 128), fb, pol_a);
            tma::load_box(dst + tma::A_HALF, &a_map, g * BC + 64,
                          (int)(s * 128), fb, pol_a);
#pragma unroll
            for (int v = 0; v < C::NBOX; ++v)
              tma::load_box(dst + tma::A_BYTES + v * C::V_BOX, &v_map,
                            ct * 128 + v * C::W, bcb * BC, fb, pol_v);
          }
          next_stage();
        }
      }
      __syncwarp();
#ifdef VRES_ONE_ITEM_PER_CTA
      item = items;
#else
      item = __shfl_sync(0xffffffffu, nxt, 0);
#endif
    }
    if (lane == 0) {   // tell the consumers to stop
      tma::bar_wait(empty + 8 * stage, phase);
      meta[stage] = make_int4(0, 0, tma::DONE, 0);
      tma::bar_arrive(full + 8 * stage);
    }
    return;
  }

  // ---- consumer warpgroups ------------------------------------------------
  const int wg = tid / 128;
  const int t = tid % 128;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    tma::bar_wait(full + 8 * stage, phase);
    const int4 m = meta[stage];
    if (m.z & tma::DONE) break;
    const uint32_t a0 = ring + stage * C::STAGE + wg * (64 * 128);
    const uint32_t b0 = ring + stage * C::STAGE + tma::A_BYTES;
    tma::fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BC / 16; ++k) {
      // A: [128, 64] boxes, 128-byte rows, 8-row groups 1024 bytes apart;
      // a k16 step moves 32 bytes along the row (inside the swizzle atom).
      const uint64_t da =
          tma::desc(a0 + (k / 4) * tma::A_HALF + (k % 4) * 32, 16, 1024, 1);
      const uint64_t db = tma::desc(b0 + k * C::V_KSTEP, C::V_LBO, C::V_SBO,
                                    C::V_LAYOUT);
      tma::Wgmma<N>::mma(acc, da, db,
                         (k == 0 && (m.z & tma::FIRST)) ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    tma::fence_acc(acc);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tma::fence_acc(acc);
    if (t % 32 == 0) tma::bar_arrive(empty + 8 * stage);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
    if (m.z & tma::LAST) {
      // Accumulator i of thread t: row 16*(t/32) + (t%32)/4 + 8*((i/2)%2),
      // column 8*(i/4) + 2*(t%4) + i%2 of the warpgroup's [64, N] tile.
      const int64_t row =
          (int64_t)m.x * 128 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
      const int cb = m.y * 128;
#pragma unroll
      for (int c = 0; c < N / 8; ++c) {
        if (cb + 8 * c < D) {   // D % 8 == 0: an 8-column group is in or out
          const int col = cb + 8 * c + 2 * (t % 4);
          *reinterpret_cast<float2*>(&out[row * D + col]) =
              make_float2(acc[4 * c], acc[4 * c + 1]);
          *reinterpret_cast<float2*>(&out[(row + 8) * D + col]) =
              make_float2(acc[4 * c + 2], acc[4 * c + 3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 blocks: thread (ty, tx) owns rows ty*8..+8 and columns tx*4..+4.
// ---------------------------------------------------------------------------
constexpr int NT32 = 256;
constexpr int GC32 = 2;                       // column-blocks per V stack chunk
constexpr int SMEM32 = GC32 * BC * DT * 4;    // 65,536 bytes

__global__ void __launch_bounds__(NT32)
bsr_spmm_vres_f32(const int* __restrict__ row_ptr,
                  const int* __restrict__ bcols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ Vc, float* __restrict__ out,
                  int G, int D, int ndt) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Vs = reinterpret_cast<float*>(smem);   // [GC32*BC][DT]
  __shared__ float As[KC][128 + 1];

  const int64_t r = blockIdx.x / ndt;
  const int d0 = (blockIdx.x % ndt) * DT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t ld = (int64_t)G * BC;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int s0 = row_ptr[r], s1 = row_ptr[r + 1];
  for (int s = s0; s < s1; ++s) {
    const float* slab = blocks + (int64_t)s * 128 * ld;
    for (int g0 = 0; g0 < G; g0 += GC32) {
      const int gn = min(GC32, G - g0);
      for (int idx = tid; idx < gn * BC * (DT / 4); idx += NT32) {
        const int k = idx / (DT / 4), j = (idx % (DT / 4)) * 4;
        const int64_t vrow =
            (int64_t)bcols[(int64_t)s * G + g0 + k / BC] * BC + k % BC;
        const int d = d0 + j;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (d < D) v = *reinterpret_cast<const float4*>(&Vc[vrow * D + d]);
        *reinterpret_cast<float4*>(&Vs[k * DT + j]) = v;
      }
      for (int k0 = 0; k0 < gn * BC; k0 += KC) {
#pragma unroll
        for (int e = 0; e < (128 * KC) / NT32; ++e) {
          const int idx = e * NT32 + tid;
          const int i = idx / KC, kk = idx % KC;
          As[kk][i] = slab[(int64_t)i * ld + g0 * BC + k0 + kk];
        }
        __syncthreads();   // also publishes the V stack on the first slice
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          const float4 b =
              *reinterpret_cast<const float4*>(&Vs[(k0 + kk) * DT + tx * 4]);
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
  if (dc < D) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = (int64_t)r * 128 + ty * 8 + i;
      *reinterpret_cast<float4*>(&out[row * D + dc]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch, with an L2 window over V unless v_bytes is 0
// ---------------------------------------------------------------------------
template <typename Kern, typename... Args>
int launch_resident(Kern kern, int smem, dim3 grid, dim3 block,
                    cudaStream_t st, const void* Vc, size_t v_bytes,
                    Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  if (v_bytes == 0) {
    err = cudaLaunchKernelEx(&cfg, kern, args...);
    if (err == cudaSuccess) err = cudaGetLastError();
    return (int)err;
  }
  int dev = 0, max_persist = 0, max_window = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&max_persist,
                                    cudaDevAttrMaxPersistingL2CacheSize,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&max_window,
                                    cudaDevAttrMaxAccessPolicyWindowSize,
                                    dev)) != cudaSuccess)
    return (int)err;
  size_t prev = 0;
  if ((err = cudaDeviceGetLimit(&prev, cudaLimitPersistingL2CacheSize)) !=
      cudaSuccess)
    return (int)err;
  const size_t window = v_bytes < (size_t)max_window ? v_bytes : (size_t)max_window;
  const size_t want = window < (size_t)max_persist ? window : (size_t)max_persist;
  const bool raise = prev < want;
  if (raise && (err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                                         want)) != cudaSuccess)
    return (int)err;
  const size_t limit = raise ? want : prev;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow.base_ptr = const_cast<void*>(Vc);
  attr[0].val.accessPolicyWindow.num_bytes = window;
  attr[0].val.accessPolicyWindow.hitRatio =
      window == 0 ? 0.f : (limit >= window ? 1.f : (float)limit / (float)window);
  attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cfg.attrs = attr;
  cfg.numAttrs = window > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  // Give the set-aside back at once: a persisting carve-out left in place
  // takes its share of L2 from every later kernel (measured on an H100:
  // the K=100,467 MMW iteration 35.6 -> 52.1 ms with 32.8 MB set aside).
  if (raise) {
    const cudaError_t e2 =
        cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, prev);
    if (err == cudaSuccess) err = e2;
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// Tensor maps, through the driver's encoder fetched at run time
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A bf16 [outer, inner] row-major array with rows of row_bytes, read in
// [box_outer, box_inner] boxes; elements past inner or outer read as zero.
bool bf16_map(CUtensorMap* map, const void* base, uint64_t inner,
              uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
              uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_tma(const int* row_ptr, const int* bcols,
               const __nv_bfloat16* blocks, const __nv_bfloat16* Vc, int ldv,
               int* counter, float* out, int Kbr,int nsteps, int nrows, int G, int D, cudaStream_t st) {
  using C = tma::Cfg<N>;
  CUtensorMap a_map, v_map;
  if (!bf16_map(&a_map, blocks, (uint64_t)G * BC, (uint64_t)nsteps * 128,
                (uint64_t)G * BC * 2, 64, 128, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&v_map, Vc, (uint64_t)ldv, (uint64_t)nrows,
                (uint64_t)ldv * 2, C::W, BC, C::V_SWIZZLE))
    return (int)cudaErrorInvalidValue;
  const int nct = (ldv + 127) / 128;
  const int items = Kbr * nct;
  int grid = items;
#ifndef VRES_ONE_ITEM_PER_CTA
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (grid > nsm) grid = nsm;
#endif
#ifdef VRES_L2_WINDOW
  const size_t window = (size_t)nrows * ldv * 2;
#else
  const size_t window = 0;   // evict_last alone: faster at D=128, equal at 48
#endif
  return launch_resident(bsr_spmm_vres_tma<N>, C::SMEM, dim3(grid),
                         dim3(tma::NT), st, Vc, window, a_map, v_map, row_ptr,
                         bcols, counter, out, G, D, nct, items);
}

}  // namespace

extern "C" {

// Float32 blocks and a float32 V copy Vc [nrows, D] (D a multiple of 8),
// out [nrows, D] float32.  Returns the cudaError_t of the launch (0 =
// launched).
int bsr_spmm_vres_launch(const void* row_ptr, const void* bcols,
                         const void* blocks, const void* Vc, void* out,
                         int Kbr, int G, int D, void* stream) {
  const int ndt = (D + DT - 1) / DT;
  if (Kbr <= 0 || G <= 0 || D <= 0 || D % 8 != 0 ||
      (long long)Kbr * ndt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return launch_resident(bsr_spmm_vres_f32, SMEM32,
                         dim3((unsigned)((long long)Kbr * ndt)), dim3(NT32),
                         reinterpret_cast<cudaStream_t>(stream), Vc,
                         (size_t)Kbr * 128 * D * 4,
                         static_cast<const int*>(row_ptr),
                         static_cast<const int*>(bcols),
                         static_cast<const float*>(blocks),
                         static_cast<const float*>(Vc),
                         static_cast<float*>(out), G, D, ndt);
}

// Block shapes other than 128x128 (Br x Bc at run time): the contract of
// the 128x128 paths through the flat kernel's short-block tile
// (spmm_tile.cuh), with no residency hint.  bfloat16 blocks: Vb [nrows,
// ldv] bf16 rounded by the wrapper, ncols output columns per warp (16, 32,
// 48, 64, 96 or 128; ldv >= ceil(D / ncols) * ncols).  Returns the
// cudaError_t of the launch.
int bsr_spmm_vres_short_launch(const void* row_ptr, const void* bcols,
                               const void* blocks, int Br, int Bc,
                               const void* Vb, int ldv, void* out, int Kbr,
                               int G, int D, int ncols, void* stream) {
  return spmm::launch_short<__nv_bfloat16, false>(
      row_ptr, bcols, blocks, Br, Bc, Vb, ldv, out, Kbr, G, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

// Float32 blocks of those shapes (3xTF32): V [nrows, D] float32, ncols as
// above.  Returns the cudaError_t of the launch.
int bsr_spmm_vres_short_f32_launch(const void* row_ptr, const void* bcols,
                                   const void* blocks, int Br, int Bc,
                                   const void* V, void* out, int Kbr, int G,
                                   int D, int ncols, void* stream) {
  return spmm::launch_short<float, false>(
      row_ptr, bcols, blocks, Br, Bc, V, D, out, Kbr, G, D, ncols,
      reinterpret_cast<cudaStream_t>(stream));
}

// bfloat16 blocks: Vc [nrows, ldv] bf16 (ldv a multiple of 8, columns past
// D zero; ldv a multiple of 128 above 128), counter one int32 of scratch
// (zeroed here on the stream), out [nrows, D] float32.  Returns the
// cudaError_t of the launch.
int bsr_spmm_vres_bf16_launch(const void* row_ptr, const void* bcols,
                              const void* blocks, const void* Vc, int ldv,
                              void* counter, void* out, int Kbr, int nsteps,
                              int G, int D, void* stream) {
  if (Kbr <= 0 || nsteps <= 0 || G <= 0 || D <= 0 || D % 8 != 0 ||
      ldv < D || ldv % 8 != 0 || (ldv > 128 && ldv % 128 != 0) ||
      (int64_t)nsteps * 128 > INT32_MAX || (int64_t)G * BC > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(blocks);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(Vc);
  int* cnt = static_cast<int*>(counter);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nrows = Kbr * 128;
  if (ldv <= 16)
    return launch_tma<16>(rp, bc, a, v, ldv, cnt, o, Kbr, nsteps, nrows, G, D,
                          st);
  if (ldv <= 32)
    return launch_tma<32>(rp, bc, a, v, ldv, cnt, o, Kbr, nsteps, nrows, G, D,
                          st);
  if (ldv <= 64)
    return launch_tma<64>(rp, bc, a, v, ldv, cnt, o, Kbr, nsteps, nrows, G, D,
                          st);
  return launch_tma<128>(rp, bc, a, v, ldv, cnt, o, Kbr, nsteps, nrows, G, D,
                         st);
}

}  // extern "C"
