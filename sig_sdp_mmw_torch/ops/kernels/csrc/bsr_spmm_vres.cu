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
// The TMA loads of V carry an evict_last cache hint and those of the blocks
// evict_first, so the streamed blocks leave L2 before V.  A persisting
// access-policy window over V as well (VRES_L2_WINDOW, bf16 only) was no
// faster at D=48 and 1.5-1.9x slower at D=128 on an H100
// (experiments/bench_vres_parts.py), so it is not shipped.
// What bounds it: the real blocks' bytes from device memory (0.19 GB of
// bf16 at K=100,467, 0.38 GB of float32, against 0.03-0.08 GB of V and
// out), so the design keeps block loads in flight at all times and reads
// nothing it does not need; float32 at D=128 is bound by its three TF32
// products per pair as much as by its bytes.
//
// Both block dtypes run on persistent CTAs, one per SM, fed by one producer
// warp (produce_items):
//   * work items are (block-row, 128-column tile of D) in index order; a
//     CTA takes the next item from a counter the launch zeroes, so a CTA
//     that drew short rows takes more of them.  Taking the rows longest
//     first instead was no faster on an H100 at D=48 and 7% slower at
//     D=128 (bf16, device time, experiments/bench_vres_parts.py);
//   * the producer walks the item's slots, skips padding by the rule of
//     ring::next_real (spmm_tile.cuh: a slot after the row's first whose
//     column-block is 0 holds zeros), and for each real slot issues TMA
//     loads into ring stages, the block's columns and the V rows of its
//     column-block; full/empty mbarriers per stage; the stage's item and
//     first/last flags travel beside it in shared memory, so the ring runs
//     across row boundaries and the next row's loads are in flight during
//     a row's epilogue;
//   * two consumer warpgroups cover the 128 rows as m64 each on wgmma; the
//     sums stay in registers and the row's last stage is followed by
//     stores straight from the accumulator layout.  No atomics on the
//     output: two launches are bitwise equal.
// bfloat16 blocks (bsr_spmm_vres_tma<N>): a stage is a whole block, two
// [128, 64] boxes of the [nsteps*128, G*128] block array, and the V rows of
// its column-block, [128, N], as boxes of one swizzle atom's width from the
// [Kp, ldv] bf16 copy (columns past ldv come in as zeros);
// wgmma.m64nNk16 bf16 -> fp32, A K-major in 128-byte swizzle, V MN-major
// (N contiguous, the B transpose bit) in the swizzle of its atom (128 B at
// N >= 64, 64 B at N=32, 32 B at N=16).  N is ldv rounded up to 16, 32, 64
// or 128.
// float32 blocks (bsr_spmm_vres_tf32<N>), the header's 3xTF32 on wgmma: a
// stage is a 32-deep slice of a block, one [128, 32] box (128 B a row,
// 128-byte swizzle), and V's 32 matching rows as [32, 32] boxes of the
// caller's float32 V (columns past D zero).  A's fragments come from the
// swizzled stage by ldmatrix and are split into tf32 halves in registers.
// tf32 wgmma takes B only K-major, while V's rows are N-contiguous: V's
// values are split and their halves written transposed, K-major in rows of
// 128 bytes with 128-byte swizzle (rf::desc_sw128; up to 3% faster than
// ring_tile_f32's no-swizzle core matrices on an H100, bitwise equal), a
// lane's four halves as one 16-byte store; both the reads of V and the
// stores are free of bank conflicts.  Each stage's twelve MMAs
// (rf::stage_mma) start from zero and their sum is added to the tile's
// float32 sums, the header's accuracy rule.  Who splits V depends on N
// (tf::Cfg::WS; experiments/bench_vres_parts.py on the 100k S-tilde, NVIDIA
// H100):
//   * N <= 96: the two consumer warpgroups, for stage t+1 while stage t's
//     MMAs run, into the other of two B buffers, with a barrier of the 256
//     consumers between stages (0.184 ms at D=48 against 0.239 below, and
//     faster at D=96 too);
//   * N = 128: three warps of their own beside the producer (a warpgroup
//     that hands registers to the consumers with setmaxnreg), into two B
//     buffers with full/empty mbarriers; the consumer warpgroups then meet
//     at no barrier, so one's MMAs run while the other splits its A and
//     adds its sums (0.337 ms at D=128 against 0.387 above).
// The stage goes back to the producer once its A is in registers and its V
// split.  N is D rounded up to 16, 32, 48, 64, 96 or 128.
// Block shapes other than 128x128 go through the flat kernel's short-block
// tile (spmm_tile.cuh), bfloat16 (bsr_spmm_vres_short_launch) or float32
// (bsr_spmm_vres_short_f32_launch); V stays in device memory and L2 without
// a residency hint.
//
// Variants for experiments/bench_vres_parts.py (-D at build time):
// VRES_STAGES=n the bf16 ring's depth; VRES_ONE_ITEM_PER_CTA one CTA per
// item (no persistence); VRES_NO_CACHE_HINTS plain TMA loads;
// VRES_L2_WINDOW a persisting window over V for a bf16 launch;
// VRES_F32_SPLIT_WG_FROM=n the first float32 width split by warps of their
// own; VRES_F32_CORE_MATRICES float32 B in ring_tile_f32's layout;
// VRES_F32_NO_MMA, VRES_F32_NO_SPLIT the float32 body without its MMAs or
// without V's split stores (wrong results, for timing).
//
// Operands (all device pointers, contiguous):
//   row_ptr [Kbr+1] int32, bcols [nsteps*G] int32  as in bsr_spmm_flat.cu
//   blocks  [nsteps, 128, G*128] float32 or bfloat16
//   Vc      [nrows, ldv] bfloat16 (ldv a multiple of 8), or V [nrows, D]
//           float32
//   out     [nrows, D] float32 (written in full), D a multiple of 8

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the
                    // driver at run time (no -lcuda)

#include "spmm_tile.cuh"

namespace {

using spmm::BC;

// ---------------------------------------------------------------------------
// The TMA ring of both block dtypes: barriers, loads, the producer's walk
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

// The producer warp of a ring of S stages, PARTS stages per block: takes
// items (block-row r, column tile ct) from the counter (or its CTA's one
// item), walks each row's real slots in order, and for each part of each
// slot lane 0 waits for the stage to be free, writes its record {r, ct,
// flags} and calls issue(full barrier, stage, step s, group g, column-block,
// part, ct), which posts the stage's bytes and its loads.  Ends with a DONE
// record.  Called by the whole warp.
template <int S, int PARTS, typename Issue>
__device__ __forceinline__ void produce_items(
    uint32_t full, uint32_t empty, int4* meta, const int* __restrict__ row_ptr,
    const int* __restrict__ bcols, int* __restrict__ counter, int G, int nct,
    int items, Issue&& issue) {
  const int lane = threadIdx.x % 32;
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
        const int64_t s = jj / G;
        const int g = (int)(jj - s * G);
#pragma unroll 1
        for (int part = 0; part < PARTS; ++part) {
          if (lane == 0) {
            bar_wait(empty + 8 * stage, phase);
            meta[stage] = make_int4(
                r, ct,
                (jj == j0 && part == 0 ? FIRST : 0) |
                    (jj == last && part == PARTS - 1 ? LAST : 0),
                0);
            issue(full + 8 * stage, stage, s, g, bcb, part, ct);
          }
          next_stage();
        }
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
    bar_wait(empty + 8 * stage, phase);
    meta[stage] = make_int4(0, 0, DONE, 0);
    bar_arrive(full + 8 * stage);
  }
}

}  // namespace tma

// Accumulator i of lane t of warp w of a warpgroup: row 16*w + t/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(t%4) + i%2 of the warpgroup's [64, N]
// tile; row is the tile's row of this lane for i = 0.
template <int N>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[N / 2],
                                           int64_t row, int cb, int D,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    if (cb + 8 * c < D) {   // D % 8 == 0: an 8-column group is in or out
      const int col = cb + 8 * c + 2 * (lane % 4);
      *reinterpret_cast<float2*>(&out[row * D + col]) =
          make_float2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<float2*>(&out[(row + 8) * D + col]) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

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
    // ---- producer warp: a stage is one whole block --------------------------
    const uint64_t pol_a = tma::policy_evict_first();
    const uint64_t pol_v = tma::policy_evict_last();
    tma::produce_items<S, 1>(
        full, empty, meta, row_ptr, bcols, counter, G, nct, items,
        [&](uint32_t fb, int stage, int64_t s, int g, int bcb, int, int ct) {
          tma::bar_expect(fb, C::STAGE);
          const uint32_t dst = ring + stage * C::STAGE;
          tma::load_box(dst, &a_map, g * BC, (int)(s * 128), fb, pol_a);
          tma::load_box(dst + tma::A_HALF, &a_map, g * BC + 64,
                        (int)(s * 128), fb, pol_a);
#pragma unroll
          for (int v = 0; v < C::NBOX; ++v)
            tma::load_box(dst + tma::A_BYTES + v * C::V_BOX, &v_map,
                          ct * 128 + v * C::W, bcb * BC, fb, pol_v);
        });
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
    if (m.z & tma::LAST)
      store_tile<N>(out, acc,
                    (int64_t)m.x * 128 + wg * 64 + (t / 32) * 16 +
                        (t % 32) / 4,
                    m.y * 128, D, t % 32);
  }
}

// ---------------------------------------------------------------------------
// float32 blocks: 3xTF32 on wgmma from the same TMA ring
// ---------------------------------------------------------------------------
namespace tf {

constexpr int KS = 32;                      // contraction depth of a stage
constexpr int PARTS = BC / KS;              // stages per block
constexpr int A_BYTES = 128 * KS * 4;       // [128, 32] float32, 16 KB
constexpr int V_BOX = KS * 32 * 4;          // [32, 32] float32 box, 4 KB
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;            // dynamic shared memory of a CTA
constexpr int NB = 2;                       // B buffers
// Widths from which V is split by warps of their own (experiments/
// bench_vres_parts.py moves it: 0 for every width, 1000 for none).
#ifdef VRES_F32_SPLIT_WG_FROM
constexpr int SPLIT_WG_FROM = VRES_F32_SPLIT_WG_FROM;
#else
constexpr int SPLIT_WG_FROM = 128;
#endif

template <int N>
struct Cfg {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 ||
                    N == 128,
                "N: 16, 32, 48, 64, 96 or 128");
  // Split warpgroup: the producer warp and SPLITTERS warps that split V
  // beside the two consumer warpgroups; else the consumers split it.
  static constexpr bool WS = N >= SPLIT_WG_FROM;
  static constexpr int SPLITTERS = WS ? 3 : 0;
  static constexpr int NT = tma::CONSUMERS + 32 * (1 + SPLITTERS);
  static constexpr int NBOX = (N + 31) / 32;   // V boxes of 32 columns
  static constexpr int STAGE = A_BYTES + NBOX * V_BOX;
  static constexpr int B_BUF = 256 * N;        // B's hi and lo halves
  // Ring (1024-aligned for the 128-byte swizzle), the B buffers, then the
  // barriers (full, empty, and two per B buffer) and each stage's record:
  // as many stages as fit.
  static constexpr int FIT =
      (SMEM_MAX - 1024 - NB * (B_BUF + 16)) / (STAGE + 32);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static_assert(STAGES >= 3, "the float32 ring needs three stages");
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 32) + NB * (B_BUF + 16);
};

// Splits rows 4*kg .. 4*kg+3 of V box `box` of a stage (vs) into B's halves
// at hi (lo 128*N bytes after): this lane takes column n = 32*box + lane,
// reading one 128-byte row of the swizzled box per value, and writes its
// four hi (lo) halves as one 16-byte store at row n, piece kg of B's
// K-major 128-byte-swizzle layout (rf::desc_sw128; the eight lanes of a
// store phase hit eight distinct pieces).
template <int N>
__device__ __forceinline__ void split_unit(const unsigned char* vs,
                                           uint32_t hi, int kg, int box,
                                           int lane) {
  const int n = box * 32 + lane;
  if (N % 32 != 0 && n >= N) return;
  uint32_t h[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = 4 * kg + a;
    const float v = *reinterpret_cast<const float*>(
        vs + box * V_BOX + k * 128 +
        ((((lane >> 2) ^ (k & 7)) << 4) | ((lane & 3) << 2)));
    spmm::ring::tf32_split(v, h[a], l[a]);
  }
#ifdef VRES_F32_CORE_MATRICES
  // ring_tile_f32's no-swizzle core matrices: step kg/2, matrix (n/8, kg%2).
  const uint32_t w = hi + 128 * ((kg >> 1) * (N / 4) + 2 * (n >> 3) +
                                 (kg & 1)) + 16 * (n & 7);
#else
  const uint32_t w = hi + n * 128 + ((kg ^ (n & 7)) << 4);
#endif
#ifndef VRES_F32_NO_SPLIT
  spmm::sb::st_shared16(w, h[0], h[1], h[2], h[3]);
  spmm::sb::st_shared16(w + 128 * N, l[0], l[1], l[2], l[3]);
#else
  if (h[0] == 1u && l[0] == 2u) spmm::sb::st_shared16(w, 0, 0, 0, 0);
#endif
}

// This warp's A of a stage (as: the stage, plus this lane's ldmatrix row
// times 128 bytes), split into tf32 halves: the m16n8k8 fragments of its 16
// rows for the four k8 steps.  The lane's 16-byte piece of step ks is
// 2*ks + lane/16, which the 128-byte swizzle stores at (2*ks + lane/16) ^
// (row % 8).
__device__ __forceinline__ void load_a(uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4], uint32_t as,
                                       int row, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    spmm::ring::ldsm_x4(a, as + (((2 * ks + (lane >> 4)) ^ (row & 7)) << 4));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      spmm::ring::tf32_split(__uint_as_float(a[e]), ah[ks][e], al[ks][e]);
  }
}

// A stage's products into p: the twelve MMAs, or (VRES_F32_NO_MMA, for
// experiments/bench_vres_parts.py) none, p made from A so nothing is
// dropped.
template <int N>
__device__ __forceinline__ void stage_products(float (&p)[N / 2],
                                               uint32_t (&ah)[4][4],
                                               uint32_t (&al)[4][4],
                                               uint32_t bhi) {
#ifdef VRES_F32_NO_MMA
  (void)bhi;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    p[i] = __uint_as_float(ah[i % 4][i % 3] ^ al[i % 4][(i + 1) % 4]);
#else
  spmm::rf::fence_regs<4>(ah);
  spmm::rf::fence_regs<4>(al);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#ifdef VRES_F32_CORE_MATRICES
  spmm::rf::stage_mma<N, false>(p, ah, al, bhi);
#else
  spmm::rf::stage_mma<N, true>(p, ah, al, bhi);
#endif
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void finish_products(float (&p)[N / 2],
                                                uint32_t (&ah)[4][4],
                                                uint32_t (&al)[4][4]) {
#ifndef VRES_F32_NO_MMA
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  spmm::rf::fence_regs<N / 2>(p);
  spmm::rf::fence_regs<4>(ah);
  spmm::rf::fence_regs<4>(al);
#endif
}

}  // namespace tf

template <int N>
__global__ void __launch_bounds__(tf::Cfg<N>::NT, 1)
bsr_spmm_vres_tf32(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols, int* __restrict__ counter,
                   float* __restrict__ out, int G, int D, int nct,
                   int items) {
  using C = tf::Cfg<N>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tma::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* const ring_p = smem_raw + (ring - raw);
  const uint32_t bbuf = ring + S * C::STAGE;   // the B buffers
  unsigned char* top = ring_p + S * C::STAGE + tf::NB * C::B_BUF;
  const uint32_t full = tma::smem_u32(top);    // S barriers of 8 bytes
  const uint32_t empty = full + 8 * S;
  const uint32_t bfull = empty + 8 * S;        // NB barriers each
  const uint32_t bempty = bfull + 8 * tf::NB;
  int4* meta = reinterpret_cast<int4*>(top + 16 * S + 16 * tf::NB);
  const int tid = threadIdx.x;
  constexpr int CW = tma::CONSUMERS / 32;      // consumer warps

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      tma::bar_init(full + 8 * s, 1);    // the producer's arrival + bytes
      tma::bar_init(empty + 8 * s, CW + C::SPLITTERS);   // one per warp
    }
    if constexpr (C::WS) {
      for (int b = 0; b < tf::NB; ++b) {
        tma::bar_init(bfull + 8 * b, C::SPLITTERS);
        tma::bar_init(bempty + 8 * b, CW);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= tma::CONSUMERS) {
    if constexpr (C::WS) {
      // The producer and splitter warpgroup gives registers to the
      // consumers (40 + 2 x 232 a thread: 168 x 3 at launch).
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      if (tid >= tma::CONSUMERS + 32) {
        // ---- splitter warps: each stage's V into the next B buffer -------
        const int sw = tid / 32 - CW - 1, lane = tid % 32;
        int stage = 0, b = 0;
        uint32_t phase = 0, bphase = 1;   // a fresh barrier passes parity 1
        for (;;) {
          tma::bar_wait(full + 8 * stage, phase);
          if (meta[stage].z & tma::DONE) break;
          tma::bar_wait(bempty + 8 * b, bphase);
          const unsigned char* vs = ring_p + stage * C::STAGE + tf::A_BYTES;
          for (int u = sw; u < 8 * C::NBOX; u += C::SPLITTERS)
            tf::split_unit<N>(vs, bbuf + b * C::B_BUF, u % 8, u / 8, lane);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) {
            tma::bar_arrive(bfull + 8 * b);
            tma::bar_arrive(empty + 8 * stage);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
          if (++b == tf::NB) {
            b = 0;
            bphase ^= 1;
          }
        }
        return;
      }
    }
    // ---- producer warp: a stage is a 32-deep slice of a block -------------
    const uint64_t pol_a = tma::policy_evict_first();
    const uint64_t pol_v = tma::policy_evict_last();
    tma::produce_items<S, tf::PARTS>(
        full, empty, meta, row_ptr, bcols, counter, G, nct, items,
        [&](uint32_t fb, int stage, int64_t s, int g, int bcb, int part,
            int ct) {
          tma::bar_expect(fb, C::STAGE);
          const uint32_t dst = ring + stage * C::STAGE;
          tma::load_box(dst, &a_map, g * BC + part * tf::KS, (int)(s * 128),
                        fb, pol_a);
#pragma unroll
          for (int v = 0; v < C::NBOX; ++v)
            tma::load_box(dst + tf::A_BYTES + v * tf::V_BOX, &v_map,
                          ct * 128 + v * 32, bcb * BC + part * tf::KS, fb,
                          pol_v);
        });
    return;
  }

  // ---- consumer warpgroups ------------------------------------------------
  if constexpr (C::WS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = tid / 32;                  // consumer warp, 0..7
  const int wg = cw / 4, warp = cw % 4, lane = tid % 32;
  // This lane's ldmatrix row: row (lane%8) + 8*((lane/8)%2) of the warp's 16.
  const int arow = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // A stage's products into the tile's sums; the row's last stores them.
  auto retire = [&](const int4& m, const float (&p)[N / 2]) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += p[i];
    if (m.z & tma::LAST) {
      store_tile<N>(out, acc,
                    (int64_t)m.x * 128 + wg * 64 + warp * 16 + lane / 4,
                    m.y * 128, D, lane);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    }
  };

  int stage = 0, b = 0;
  uint32_t phase = 0;
  if constexpr (C::WS) {
    // Each warpgroup on its own: a stage's A once it has landed, its B
    // once the splitters have written it; the warpgroups meet at no
    // barrier, so one's MMAs run while the other splits its A and adds.
    uint32_t bphase = 0;
    for (;;) {
      tma::bar_wait(full + 8 * stage, phase);
      const int4 m = meta[stage];
      if (m.z & tma::DONE) break;
      uint32_t ah[4][4], al[4][4];
      tf::load_a(ah, al, ring + stage * C::STAGE + arow * 128, arow, lane);
      __syncwarp();
      if (lane == 0) tma::bar_arrive(empty + 8 * stage);   // A read
      tma::bar_wait(bfull + 8 * b, bphase);
      float p[N / 2];
      tf::stage_products<N>(p, ah, al, bbuf + b * C::B_BUF);
      tf::finish_products<N>(p, ah, al);
      __syncwarp();
      if (lane == 0) tma::bar_arrive(bempty + 8 * b);      // B read
      retire(m, p);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      if (++b == tf::NB) {
        b = 0;
        bphase ^= 1;
      }
    }
  } else {
    // Both warpgroups split the next stage's V while the tensor cores run,
    // into the other of two B buffers; the 256 consumers meet at a barrier
    // between stages.
    auto split_v = [&](int st, int buf) {
      const unsigned char* vs = ring_p + st * C::STAGE + tf::A_BYTES;
#pragma unroll
      for (int box = 0; box < C::NBOX; ++box)
        tf::split_unit<N>(vs, bbuf + buf * C::B_BUF, cw, box, lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    tma::bar_wait(full, 0);
    int4 nx = meta[0];
    if (!(nx.z & tma::DONE)) split_v(0, 0);
    while (!(nx.z & tma::DONE)) {
      // Every consumer has split this stage's V and finished the last
      // stage's MMAs, which read the other buffer.
      asm volatile("bar.sync 1, %0;\n" ::"n"(tma::CONSUMERS) : "memory");
      const int4 m = nx;
      uint32_t ah[4][4], al[4][4];
      tf::load_a(ah, al, ring + stage * C::STAGE + arow * 128, arow, lane);
      __syncwarp();
      if (lane == 0) tma::bar_arrive(empty + 8 * stage);   // A and V read
      float p[N / 2];
      tf::stage_products<N>(p, ah, al, bbuf + b * C::B_BUF);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      tma::bar_wait(full + 8 * stage, phase);
      nx = meta[stage];
      if (!(nx.z & tma::DONE)) split_v(stage, b ^ 1);
      tf::finish_products<N>(p, ah, al);
      retire(m, p);
      b ^= 1;
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

// An [outer, inner] row-major array of `type` with rows of row_bytes, read
// in [box_outer, box_inner] boxes; elements past inner or outer read as
// zero.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                uint64_t inner, uint64_t outer, uint64_t row_bytes,
                uint32_t box_inner, uint32_t box_outer,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The grid of a persistent launch over `items` items (one CTA per SM at
// most, the counter zeroed on the stream), or one CTA per item.
int persistent_grid(int items, int* counter, cudaStream_t st, int* grid) {
  *grid = items;
#ifndef VRES_ONE_ITEM_PER_CTA
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (*grid > nsm) *grid = nsm;
#else
  (void)counter;
  (void)st;
#endif
  return 0;
}

template <int N>
int launch_tma(const int* row_ptr, const int* bcols,
               const __nv_bfloat16* blocks, const __nv_bfloat16* Vc, int ldv,
               int* counter, float* out, int Kbr, int nsteps, int nrows,
               int G, int D, cudaStream_t st) {
  using C = tma::Cfg<N>;
  CUtensorMap a_map, v_map;
  if (!tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, blocks,
                  (uint64_t)G * BC, (uint64_t)nsteps * 128,
                  (uint64_t)G * BC * 2, 64, 128, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, Vc, (uint64_t)ldv,
                  (uint64_t)nrows, (uint64_t)ldv * 2, C::W, BC,
                  C::V_SWIZZLE))
    return (int)cudaErrorInvalidValue;
  const int nct = (ldv + 127) / 128;
  const int items = Kbr * nct;
  int grid = 0;
  const int err = persistent_grid(items, counter, st, &grid);
  if (err != 0) return err;
#ifdef VRES_L2_WINDOW
  const size_t window = (size_t)nrows * ldv * 2;
#else
  const size_t window = 0;   // evict_last alone: faster at D=128, equal at 48
#endif
  return launch_resident(bsr_spmm_vres_tma<N>, C::SMEM, dim3(grid),
                         dim3(tma::NT), st, Vc, window, a_map, v_map, row_ptr,
                         bcols, counter, out, G, D, nct, items);
}

template <int N>
int launch_tf32(const int* row_ptr, const int* bcols, const float* blocks,
                const float* V, int* counter, float* out, int Kbr,
                int nsteps, int nrows, int G, int D, cudaStream_t st) {
  using C = tf::Cfg<N>;
  CUtensorMap a_map, v_map;
  if (!tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, blocks,
                  (uint64_t)G * BC, (uint64_t)nsteps * 128,
                  (uint64_t)G * BC * 4, tf::KS, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, V, (uint64_t)D,
                  (uint64_t)nrows, (uint64_t)D * 4, 32, tf::KS,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int nct = (D + 127) / 128;
  const int items = Kbr * nct;
  int grid = 0;
  const int err = persistent_grid(items, counter, st, &grid);
  if (err != 0) return err;
  return launch_resident(bsr_spmm_vres_tf32<N>, C::SMEM, dim3(grid),
                         dim3(C::NT), st, nullptr, 0, a_map, v_map, row_ptr,
                         bcols, counter, out, G, D, nct, items);
}

}  // namespace

extern "C" {

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

// float32 blocks (3xTF32): V [nrows, D] float32 (D a multiple of 8; the
// tile's columns past D are read as zeros), counter one int32 of scratch
// (zeroed here on the stream), out [nrows, D] float32.  Returns the
// cudaError_t of the launch.
int bsr_spmm_vres_f32_launch(const void* row_ptr, const void* bcols,
                             const void* blocks, const void* V,
                             void* counter, void* out, int Kbr, int nsteps,
                             int G, int D, void* stream) {
  if (Kbr <= 0 || nsteps <= 0 || G <= 0 || D <= 0 || D % 8 != 0 ||
      (int64_t)nsteps * 128 > INT32_MAX || (int64_t)G * BC > INT32_MAX ||
      (int64_t)Kbr * 128 > INT32_MAX ||
      (int64_t)Kbr * ((D + 127) / 128) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const float* a = static_cast<const float*>(blocks);
  const float* v = static_cast<const float*>(V);
  int* cnt = static_cast<int*>(counter);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nrows = Kbr * 128;
#define VRES_TF32(n) \
  launch_tf32<n>(rp, bc, a, v, cnt, o, Kbr, nsteps, nrows, G, D, st)
  if (D <= 16) return VRES_TF32(16);
  if (D <= 32) return VRES_TF32(32);
  if (D <= 48) return VRES_TF32(48);
  if (D <= 64) return VRES_TF32(64);
  if (D <= 96) return VRES_TF32(96);
  return VRES_TF32(128);
#undef VRES_TF32
}

}  // extern "C"
