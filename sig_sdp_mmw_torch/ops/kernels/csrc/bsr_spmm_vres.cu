// Flat block-CSR SpMM with V held resident for Hopper: out = A @ V, A stored
// as only its real 128x128 blocks, G per step.
//
// Replaces the TPU kernel sig_sdp_mmw_tpu/ops/bcsr.py::bsr_spmm_pallas_vres:
// the contract of bsr_spmm_pallas_flat (V cast to the block dtype, products
// summed in float32, every output row-block written once) with all of V
// resident on-chip and each step's G V column-blocks stacked into one
// [G*128, D] scratch for one wide dot.
//
// What "resident V" means on this card.  No SM holds all of V (9.6 MB of
// bf16 at K=100,467 and D=48, 25.7 MB at D=128), but the 50 MB L2 does:
//   * the wrapper casts V to the block dtype once (as the TPU kernel does)
//     and passes that copy here;
//   * the launch gives the copy an L2 access-policy window with hitProp
//     persisting (missProp streaming), as a launch attribute: it holds for
//     this launch only and no later kernel runs under it.  The persisting
//     set-aside is raised to the copy's size (at most the device maximum)
//     for the launch and put back to its previous size right after, since
//     a set-aside left in place slows every later kernel (see the note at
//     the end of launch_resident);
//   * each CTA (one per block-row and 64-column D tile) stacks a step's
//     column-blocks of V contiguously in shared memory as [GC*128, 64] with
//     16-byte copies, GC at a time (the full [32*128, 64] stack of G=32 is
//     512 KB of bf16, over the 227 KB a CTA may hold), then runs one
//     contraction over the stack without further barriers: bf16 A fragments
//     are loaded straight from device memory into the tensor cores (WMMA
//     m16n16k16, fp32 accumulate); float32 blocks take fp32 FMA with A
//     staged per 32-wide slice (full float32 precision, no TF32).
// What bounds it: the stored block bytes, streamed once per D tile, as in
// the flat kernel; the V traffic goes to L2 instead of device memory.
// Deliberately simple: no cp.async/TMA pipelining and no wgmma.
//
// Operands (all device pointers, contiguous):
//   row_ptr [Kbr+1] int32, bcols [nsteps*G] int32  as in bsr_spmm_flat.cu
//   blocks  [nsteps, 128, G*128] float32 or bfloat16 (32-byte aligned)
//   Vc      [nrows, D] in the block dtype, D a multiple of 8
//   out     [nrows, D] float32 (written in full)

#include "spmm_tile.cuh"

namespace {

using spmm::BC;
using spmm::DT;
using spmm::KC;

constexpr int NT = 256;
constexpr int GC16 = 4;               // column-blocks per bf16 stack chunk
constexpr int LDV = DT + 8;           // bf16 stack row (16-byte aligned rows)
constexpr int SMEM16 = GC16 * BC * LDV * 2 > 128 * spmm::LDC * 4
                           ? GC16 * BC * LDV * 2
                           : 128 * spmm::LDC * 4;   // 73,728 bytes
constexpr int GC32 = 2;               // column-blocks per float32 stack chunk
constexpr int SMEM32 = GC32 * BC * DT * 4;          // 65,536 bytes

__global__ void __launch_bounds__(NT)
bsr_spmm_vres_bf16(const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols,
                   const __nv_bfloat16* __restrict__ blocks,
                   const __nv_bfloat16* __restrict__ Vc,
                   float* __restrict__ out, int G, int D) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem);   // [GC16*BC][LDV]

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
    const __nv_bfloat16* slab = blocks + (int64_t)s * 128 * ld;
    for (int g0 = 0; g0 < G; g0 += GC16) {
      const int gn = min(GC16, G - g0);
      // Stack gn column-blocks of V: [gn*128, 64] as 16-byte vectors.
      for (int idx = tid; idx < gn * BC * (DT / 8); idx += NT) {
        const int k = idx / (DT / 8), jv = (idx % (DT / 8)) * 8;
        const int64_t vrow =
            (int64_t)bcols[(int64_t)s * G + g0 + k / BC] * BC + k % BC;
        const int d = d0 + jv;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (d < D) v = *reinterpret_cast<const uint4*>(&Vc[vrow * D + d]);
        *reinterpret_cast<uint4*>(&Vs[k * LDV + jv]) = v;
      }
      __syncthreads();
      // One contraction over the stack; A fragments come from device memory.
      for (int kk = 0; kk < gn * BC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              a[i], slab + (int64_t)(wr * 32 + i * 16) * ld + g0 * BC + kk,
              (unsigned)ld);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Vs + kk * LDV + wc * 32 + j * 16, LDV);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
      }
      __syncthreads();
    }
  }
  spmm::wmma_store_tile(c, reinterpret_cast<float*>(smem), out, D, r, d0);
}

// float32 blocks: thread (ty, tx) owns rows ty*8..+8 and columns tx*4..+4.
__global__ void __launch_bounds__(NT)
bsr_spmm_vres_f32(const int* __restrict__ row_ptr,
                  const int* __restrict__ bcols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ Vc, float* __restrict__ out,
                  int G, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Vs = reinterpret_cast<float*>(smem);   // [GC32*BC][DT]
  __shared__ float As[KC][128 + 1];

  const int r = blockIdx.y;
  const int d0 = blockIdx.x * DT;
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
      for (int idx = tid; idx < gn * BC * (DT / 4); idx += NT) {
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
        for (int e = 0; e < (128 * KC) / NT; ++e) {
          const int idx = e * NT + tid;
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

template <typename Kern, typename... Args>
int launch_resident(Kern kern, int smem, dim3 grid, cudaStream_t st,
                    const void* Vc, size_t v_bytes, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
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

}  // namespace

extern "C" {

// blk_dtype: 0 = float32 blocks and V copy, 1 = bfloat16 ones.  v_bytes: the
// size of Vc.  Returns the cudaError_t of the launch (0 = launched).
int bsr_spmm_vres_launch(const void* row_ptr, const void* bcols,
                         const void* blocks, int blk_dtype, const void* Vc,
                         long long v_bytes, void* out, int Kbr, int G, int D,
                         void* stream) {
  if (Kbr <= 0 || Kbr > 65535 || G <= 0 || D <= 0 || D % 8 != 0 ||
      v_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((D + DT - 1) / DT, Kbr);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  float* o = static_cast<float*>(out);
  if (blk_dtype == 1)
    return launch_resident(bsr_spmm_vres_bf16, SMEM16, grid, st, Vc,
                           (size_t)v_bytes, rp, bc,
                           static_cast<const __nv_bfloat16*>(blocks),
                           static_cast<const __nv_bfloat16*>(Vc), o, G, D);
  if (blk_dtype == 0)
    return launch_resident(bsr_spmm_vres_f32, SMEM32, grid, st, Vc,
                           (size_t)v_bytes, rp, bc,
                           static_cast<const float*>(blocks),
                           static_cast<const float*>(Vc), o, G, D);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
