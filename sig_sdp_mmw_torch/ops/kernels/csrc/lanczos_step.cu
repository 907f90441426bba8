// Lanczos steps for Hopper: the batched m-step recurrence of
// ops/expm.py::lanczos_tridiag over the D columns of a [Kp, D] block, four
// passes a step, and the final combination of the Krylov basis.
//
// Replaces no TPU kernel.  The JAX package leaves the recurrence to XLA,
// which fuses its vector work; the port's plain PyTorch version of it
// (lanczos_tridiag_reference, the same module) takes about 30 small
// kernels a step.  Each pass here does the work of several of them.
//
// One step, with j the step, q = Q_j the basis slot j, and every block a
// row-major [Kp, D] array in the solve's float type T:
//   A (lanczos_sum_kernel):  y = s * (d*q + P_Q + h*P_S + P_St) (split
//     form: the operator's three block products and its diagonal, added in
//     the order the solver's L_apply adds them, so y is that product's
//     bits) or y = s * P (generic form: P the caller's product);
//     w = y - beta_{j-1} * q_{j-1}, written; alpha_j = sum_k q*w.
//   B (lanczos_project_kernel):  u = w - alpha_j * q formed on the fly;
//     p_i = sum_k Q_i*u for the slots i <= j only.
//   C (lanczos_subtract_kernel):  w3 = u - sum_{i<=j} p_i Q_i, written;
//     beta_j = |w3| with the recurrence's breakdown guard.
//   D (lanczos_normalize_kernel):  q_{j+1} = w3 / beta_j (0 where beta_j is
//     0) into slot j+1; in split form also the next products' operands in
//     their block type, q_{j+1} and h*q_{j+1} over the operand's padded rows
//     (padding zero): the bits the SpMM wrappers' cast of those vectors
//     makes, so the products see the same inputs.
// The elementwise arithmetic is the plain version's, operation by operation
// in round-to-nearest (no contraction into FMAs), so y, w, u, w3 and q_{j+1}
// differ from it only through the sums alpha, p and beta.
//
// What bounds it: device-memory bytes.  A step reads and writes about
// 14 + 2j blocks (A: q, q_{j-1}, three products, w; B: w and j+1 slots; C:
// the same and w3; D: w3, q_{j+1} and two bfloat16 operands), so at the
// 100k sketch ([100,467 x 128] float32, 51.4 MB a block) 1.18 GB a step on
// average over m = 10, 0.35 ms at 3.35 TB/s.  The design:
//   * every pass streams whole rows of D contiguous columns, 16 bytes a
//     thread access (4 floats or 2 doubles; 1 element where D does not
//     allow it), a warp on neighbouring addresses;
//   * the sums over the Kp rows are two-stage and in a fixed order, with no
//     floating-point atomics, so a solve repeats bit for bit: each CTA sums
//     its contiguous rows per column (a fixed tree over its row lanes) into
//     a partial; the last CTA of each group of 16 (an integer counter) adds
//     the group's partials in index order, and the last group adds the
//     groups' in index order and finalises (alpha; p; beta with the guard;
//     beta0) in the same launch;
//   * the projections read only the slots 0..j (the plain version's
//     batched products read all m and mask the rest), up to 12 slots'
//     sums held in registers at a time;
//   * nothing is read back to the host: each pass finds the coefficients
//     the one before wrote in device memory, in stream order.
// The grid is the same for every pass of a call: contiguous row ranges of
// whole row sweeps, at most two CTAs per SM, so Kp from a few hundred to a
// million and any D up to 256 (1024 for float32 in 16-byte accesses) share
// one code path.
//
// The host side (lanczos_plan_*) resolves the shapes, the grid and every
// buffer once per call, so a step is four plain launches.  Each launch
// function returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int CTAS_PER_SM = 2;   // CTAs of a pass on one SM
constexpr int GROUP = 16;        // CTAs whose partials one CTA adds first

enum Dtype { NONE = -1, F32 = 0, F64 = 1, BF16 = 2 };

struct Plan {
  int dtype;       // T: F32 or F64
  int op_dtype;    // the split form's operands: F32, F64, BF16; NONE generic
  int vec;         // elements per 16-byte access (1 where D forbids it)
  int D, m, nblk, ngroups;
  long long Kp, nrows, rows_per_blk;
  double scale;
  void* basis;     // [m, Kp, D]
  void* coefs;     // alphas [m, D], betas [m, D], proj [m, D], beta0 [D]
  void* w;         // [Kp, D]
  void* w3;        // [Kp, D]
  void* part;      // [nblk, m*D] CTA partials
  void* gpart;     // [ngroups, m*D] group partials
  unsigned* counters;  // [ngroups + 1], zero between launches
  const void* d;   // [Kp] split form: the diagonal
  const void* h;   // [Kp] split form: the row coefficients of S~
  void* op_q;      // [nrows, D] split form: q in the operand type
  void* op_hq;     // [nrows, D] split form: h*q in the operand type
  cudaStream_t stream;
};

struct NoOperand {};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename O, typename T>
__device__ __forceinline__ O to(T x) {
  if constexpr (std::is_same<O, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(x);
  } else {
    return static_cast<O>(x);
  }
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <int N, typename T>
__device__ __forceinline__ Vec<T, N> load(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <int N, typename T>
__device__ __forceinline__ void store(T* p, const Vec<T, N>& x) {
  *reinterpret_cast<Vec<T, N>*>(p) = x;
}

// A thread's place in its CTA: column group cg (columns c0..c0+VEC-1) of
// row lane rl; R row lanes sweep the CTA's rows together.
template <int VEC>
struct Lanes {
  int R, rl, c0;
  bool on;
  __device__ explicit Lanes(int D) {
    const int cg_count = D / VEC;
    R = NT / cg_count;
    rl = threadIdx.x / cg_count;
    c0 = (threadIdx.x % cg_count) * VEC;
    on = rl < R;
  }
};

// The CTA's contiguous rows [r0, r1).
struct Rows {
  long long r0, r1;
  __device__ explicit Rows(const Plan& p) {
    r0 = blockIdx.x * p.rows_per_blk;
    r1 = r0 + p.rows_per_blk < p.Kp ? r0 + p.rows_per_blk : p.Kp;
  }
};

// Slots whose column sums one CTA-wide reduction takes at once.
constexpr int RED_SLOTS = 4;

// For each slot i < ns of acc, sum each column's values over the CTA's row
// lanes (a fixed tree) and write the CTA's D sums to out + i * D.  Every
// thread of the CTA calls it; red holds RED_SLOTS * NT * 16 bytes.
template <typename T, int VEC, int NS>
__device__ __forceinline__ void cta_column_sums(const T (*acc)[VEC], int ns,
                                                const Lanes<VEC>& L, int D,
                                                T* red, T* out) {
  constexpr int STRIDE = NT * 16 / sizeof(T);   // elements a slot may fill
  if (ns > NS) ns = NS;
  if (L.on) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i < ns) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          red[i * STRIDE + L.rl * D + L.c0 + v] = acc[i][v];
      }
    }
  }
  __syncthreads();
  int s = 1;
  while (s < L.R) s <<= 1;
  for (s >>= 1; s > 0; s >>= 1) {
    for (int t = threadIdx.x; t < ns * s * D; t += NT) {
      const int i = t / (s * D), e = t % (s * D);
      if (e / D + s < L.R)
        red[i * STRIDE + e] = add_rn(red[i * STRIDE + e],
                                     red[i * STRIDE + e + s * D]);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < ns * D; t += NT)
    out[t] = red[(t / D) * STRIDE + t % D];
  __syncthreads();
}

// sum_{k < n} x[k * stride] in index order, GROUP loads in flight at a
// time (n >= 1).
template <typename T>
__device__ T sum_in_order(const T* x, size_t stride, int n) {
  T s = T(0);
  for (int k0 = 0; k0 < n; k0 += GROUP) {
    T v[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      v[k] = k0 + k < n ? __ldcg(x + (k0 + k) * stride) : T(0);
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (k0 + k < n) s = k0 + k == 0 ? v[k] : add_rn(s, v[k]);
  }
  return s;
}

// The CTAs' partials part[b][o] (o < nout) of this launch, summed over b in
// a fixed order: the last CTA of each group of GROUP to finish adds its
// group's in index order, and the last group's adder adds the groups' in
// index order and calls fin(o, total).  The counters are zero on entry and
// left zero for the next launch.
template <typename T, typename Fin>
__device__ void finalize(const Plan& p, int nout, Fin fin) {
  __shared__ bool last;
  const T* part = static_cast<const T*>(p.part);
  T* gpart = static_cast<T*>(p.gpart);
  const int nb = gridDim.x, g = blockIdx.x / GROUP;
  const int ng = (nb + GROUP - 1) / GROUP;
  const int b0 = g * GROUP, b1 = b0 + GROUP < nb ? b0 + GROUP : nb;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.counters + g, 1u) == static_cast<unsigned>(b1 - b0 - 1);
  __syncthreads();
  if (!last) return;
  for (int o = threadIdx.x; o < nout; o += NT) {
    const T s = sum_in_order(part + static_cast<size_t>(b0) * nout + o,
                             static_cast<size_t>(nout), b1 - b0);
    if (ng == 1)
      fin(o, s);
    else
      gpart[static_cast<size_t>(g) * nout + o] = s;
  }
  if (threadIdx.x == 0) p.counters[g] = 0;
  if (ng == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.counters + ng, 1u) == static_cast<unsigned>(ng - 1);
  __syncthreads();
  if (!last) return;
  for (int o = threadIdx.x; o < nout; o += NT)
    fin(o, sum_in_order(gpart + o, static_cast<size_t>(nout), ng));
  if (threadIdx.x == 0) p.counters[ng] = 0;
}

template <typename T>
__device__ __forceinline__ T* reduce_space() {
  __shared__ __align__(16) unsigned char raw[RED_SLOTS * NT * 16];
  return reinterpret_cast<T*>(raw);
}

// Pass A.  P0, P1, P2: the products of q's operands by Q, S~ and S~T (split
// form), or P0 the generic product; ld*: their row strides.
template <typename T, int VEC, bool SPLIT>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
lanczos_sum_kernel(const Plan p, int j, const T* __restrict__ P0,
                   long long ld0, const T* __restrict__ P1, long long ld1,
                   const T* __restrict__ P2, long long ld2) {
  T* red = reduce_space<T>();
  const int D = p.D;
  const long long KD = p.Kp * D;
  const Lanes<VEC> L(D);
  const Rows rows(p);
  const T* basis = static_cast<const T*>(p.basis);
  const T* __restrict__ q = basis + j * KD;
  const T* __restrict__ qp = basis + (j - 1) * KD;
  T* coefs = static_cast<T*>(p.coefs);
  T* __restrict__ w = static_cast<T*>(p.w);
  const T* __restrict__ d = static_cast<const T*>(p.d);
  const T* __restrict__ h = static_cast<const T*>(p.h);
  const T s = static_cast<T>(p.scale);
  T bp[VEC] = {}, acc[1][VEC] = {};
  if (L.on && j > 0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) bp[v] = coefs[(p.m + j - 1) * D + L.c0 + v];
  }
  if (L.on) {
    for (long long r = rows.r0 + L.rl; r < rows.r1; r += L.R) {
      const long long o = r * D + L.c0;
      const Vec<T, VEC> qv = load<VEC>(q + o);
      Vec<T, VEC> y;
      if constexpr (SPLIT) {
        const Vec<T, VEC> a = load<VEC>(P0 + r * ld0 + L.c0);
        const Vec<T, VEC> b = load<VEC>(P1 + r * ld1 + L.c0);
        const Vec<T, VEC> c = load<VEC>(P2 + r * ld2 + L.c0);
        const T dr = d[r], hr = h[r];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          T t = mul_rn(dr, qv.v[v]);
          t = add_rn(t, a.v[v]);
          t = add_rn(t, mul_rn(hr, b.v[v]));
          y.v[v] = add_rn(t, c.v[v]);
        }
      } else {
        y = load<VEC>(P0 + r * ld0 + L.c0);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) y.v[v] = mul_rn(s, y.v[v]);
      if (j > 0) {
        const Vec<T, VEC> qpv = load<VEC>(qp + o);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          y.v[v] = sub_rn(y.v[v], mul_rn(bp[v], qpv.v[v]));
      }
      store<VEC>(w + o, y);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[0][v] = add_rn(acc[0][v], mul_rn(qv.v[v], y.v[v]));
    }
  }
  cta_column_sums<T, VEC, 1>(acc, 1, L, D, red,
                             static_cast<T*>(p.part) + static_cast<size_t>(blockIdx.x) * D);
  finalize<T>(p, D, [&](int o, T v) { coefs[j * D + o] = v; });
}

// Pass B: the projections p_i of u = w - alpha_j q on the slots i <= j,
// SLOTS of them summed in registers at once (the launch picks 4, 8 or 12,
// the fewest that cover j + 1, so the registers left keep a sweep's loads in
// flight; more slots take further sweeps of the rows).
template <typename T, int VEC, int SLOTS>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
lanczos_project_kernel(const Plan p, int j) {
  T* red = reduce_space<T>();
  const int D = p.D, nslots = j + 1, nout = nslots * D;
  const long long KD = p.Kp * D;
  const Lanes<VEC> L(D);
  const Rows rows(p);
  const T* __restrict__ basis = static_cast<const T*>(p.basis);
  const T* __restrict__ q = basis + j * KD;
  const T* __restrict__ w = static_cast<const T*>(p.w);
  T* coefs = static_cast<T*>(p.coefs);
  T* part = static_cast<T*>(p.part) + static_cast<size_t>(blockIdx.x) * nout;
  T a[VEC] = {};
  if (L.on) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = coefs[j * D + L.c0 + v];
  }
  for (int i0 = 0; i0 < nslots; i0 += SLOTS) {
    const int ns = nslots - i0 < SLOTS ? nslots - i0 : SLOTS;
    T acc[SLOTS][VEC] = {};
    if (L.on) {
      for (long long r = rows.r0 + L.rl; r < rows.r1; r += L.R) {
        const long long o = r * D + L.c0;
        const Vec<T, VEC> wv = load<VEC>(w + o), qv = load<VEC>(q + o);
        T u[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          u[v] = sub_rn(wv.v[v], mul_rn(a[v], qv.v[v]));
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          if (i < ns) {
            const Vec<T, VEC> Qi = load<VEC>(basis + (i0 + i) * KD + o);
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[i][v] = fma(Qi.v[v], u[v], acc[i][v]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SLOTS; i += RED_SLOTS)
      if (i < ns)
        cta_column_sums<T, VEC, RED_SLOTS>(acc + i, ns - i, L, D, red,
                                           part + (i0 + i) * D);
  }
  T* proj = coefs + 2 * p.m * D;
  finalize<T>(p, nout, [&](int o, T v) { proj[o] = v; });
}

// Pass C: w3 = u - sum_{i < nslots} p_i Q_i and beta_j = |w3| (nslots 0:
// w3 = u, the recurrence without re-orthogonalisation).  START: the column
// norms beta0 of the start block V instead (nothing written but beta0).
template <typename T, int VEC, bool START>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
lanczos_subtract_kernel(const Plan p, int j, int nslots,
                        const T* __restrict__ V) {
  T* red = reduce_space<T>();
  const int D = p.D, m = p.m;
  const long long KD = p.Kp * D;
  const Lanes<VEC> L(D);
  const Rows rows(p);
  const T* __restrict__ basis = static_cast<const T*>(p.basis);
  const T* __restrict__ q = basis + j * KD;
  const T* __restrict__ w = static_cast<const T*>(p.w);
  T* __restrict__ w3 = static_cast<T*>(p.w3);
  T* coefs = static_cast<T*>(p.coefs);
  const T* proj = coefs + 2 * m * D;
  T* beta0 = coefs + 3 * m * D;
  T a[VEC] = {}, acc[1][VEC] = {};
  if (!START && L.on) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = coefs[j * D + L.c0 + v];
  }
  if (L.on) {
    for (long long r = rows.r0 + L.rl; r < rows.r1; r += L.R) {
      const long long o = r * D + L.c0;
      T x[VEC];
      if constexpr (START) {
        const Vec<T, VEC> vv = load<VEC>(V + o);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = vv.v[v];
      } else {
        const Vec<T, VEC> wv = load<VEC>(w + o), qv = load<VEC>(q + o);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          x[v] = sub_rn(wv.v[v], mul_rn(a[v], qv.v[v]));
        if (nslots > 0) {
          T sum[VEC] = {};
          for (int i = 0; i < nslots; ++i) {
            const Vec<T, VEC> Qi = load<VEC>(basis + i * KD + o);
            const Vec<T, VEC> pi = load<VEC>(proj + i * D + L.c0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) sum[v] = fma(pi.v[v], Qi.v[v], sum[v]);
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[v] = sub_rn(x[v], sum[v]);
        }
        Vec<T, VEC> xv;
#pragma unroll
        for (int v = 0; v < VEC; ++v) xv.v[v] = x[v];
        store<VEC>(w3 + o, xv);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[0][v] = add_rn(acc[0][v], mul_rn(x[v], x[v]));
    }
  }
  cta_column_sums<T, VEC, 1>(acc, 1, L, D, red,
                             static_cast<T*>(p.part) + static_cast<size_t>(blockIdx.x) * D);
  if constexpr (START) {
    finalize<T>(p, D, [&](int o, T v) { beta0[o] = sqrt_rn(v); });
  } else {
    T* betas = coefs + m * D;
    finalize<T>(p, D, [&](int o, T v) {
      // Happy breakdown: an invariant subspace found stops the column.
      const T b = sqrt_rn(v), lo = static_cast<T>(1e-20);
      const T b0 = beta0[o] < lo ? lo : beta0[o];
      betas[j * D + o] = b > mul_rn(static_cast<T>(1e-8), b0) ? b : T(0);
    });
  }
}

// Pass D: qn = src / beta (0 where beta is not positive), and with an
// operand type O the split form's operands of qn.
template <typename T, int VEC, typename O>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
lanczos_normalize_kernel(const Plan p, const T* __restrict__ src,
                         const T* __restrict__ beta, T* __restrict__ qn) {
  const int D = p.D;
  const Lanes<VEC> L(D);
  const Rows rows(p);
  constexpr bool OPERANDS = !std::is_same<O, NoOperand>::value;
  const T* __restrict__ h = static_cast<const T*>(p.h);
  O* __restrict__ op_q = static_cast<O*>(p.op_q);
  O* __restrict__ op_hq = static_cast<O*>(p.op_hq);
  T bt[VEC] = {};
  if (L.on) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) bt[v] = beta[L.c0 + v];
    for (long long r = rows.r0 + L.rl; r < rows.r1; r += L.R) {
      const long long o = r * D + L.c0;
      const Vec<T, VEC> x = load<VEC>(src + o);
      Vec<T, VEC> y;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        y.v[v] = bt[v] > T(0) ? div_rn(x.v[v], bt[v]) : T(0);
      store<VEC>(qn + o, y);
      if constexpr (OPERANDS) {
        const T hr = h[r];
        Vec<O, VEC> a, b;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          a.v[v] = to<O>(y.v[v]);
          b.v[v] = to<O>(mul_rn(hr, y.v[v]));
        }
        store<VEC>(op_q + o, a);
        store<VEC>(op_hq + o, b);
      }
    }
  }
  if constexpr (OPERANDS) {
    const long long base = p.Kp * D, n = (p.nrows - p.Kp) * D;
    for (long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * NT) {
      op_q[base + i] = to<O>(T(0));
      op_hq[base + i] = to<O>(T(0));
    }
  }
}

// F[k, c] = sum_i coeff[c, i] Q_i[k, c].
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
lanczos_combine_kernel(const Plan p, const T* __restrict__ coeff,
                       T* __restrict__ F) {
  const int D = p.D, m = p.m;
  const long long KD = p.Kp * D;
  const Lanes<VEC> L(D);
  const Rows rows(p);
  const T* __restrict__ basis = static_cast<const T*>(p.basis);
  if (!L.on) return;
  for (long long r = rows.r0 + L.rl; r < rows.r1; r += L.R) {
    const long long o = r * D + L.c0;
    Vec<T, VEC> acc = {};
    for (int i = 0; i < m; ++i) {
      const Vec<T, VEC> Qi = load<VEC>(basis + i * KD + o);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc.v[v] = fma(coeff[(L.c0 + v) * m + i], Qi.v[v], acc.v[v]);
    }
    store<VEC>(F + o, acc);
  }
}

int vec_of(int dtype, int D) {
  const int w = dtype == F64 ? 2 : 4;
  if (D % w == 0 && D / w <= NT) return w;
  return D <= NT ? 1 : 0;
}

bool aligned(const void* ptr, long long ld, int esize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (ld * esize) % 16 == 0;
}

// The grid of a [Kp, D] pass: contiguous ranges of whole row sweeps, at
// most CTAS_PER_SM CTAs per SM.
int set_grid(Plan& p) {
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = NT / (p.D / p.vec);
  const long long sweeps = (p.Kp + R - 1) / R;
  const long long cap = static_cast<long long>(nsm) * CTAS_PER_SM;
  const long long per_blk = (sweeps + cap - 1) / cap;
  p.nblk = static_cast<int>((sweeps + per_blk - 1) / per_blk);
  p.rows_per_blk = per_blk * R;
  p.ngroups = (p.nblk + GROUP - 1) / GROUP;
  return 0;
}

// The kernels this library has launched (each launch that raised no error):
// every launch below is followed by one done().
long long launched = 0;

int done() {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++launched;
  return static_cast<int>(e);
}

template <typename T, int VEC>
int sum_launch(const Plan& p, int j, const void* P0, long long ld0,
               const void* P1, long long ld1, const void* P2, long long ld2) {
  const T* a = static_cast<const T*>(P0);
  const T* b = static_cast<const T*>(P1);
  const T* c = static_cast<const T*>(P2);
  if (p.op_dtype == NONE)
    lanczos_sum_kernel<T, VEC, false><<<p.nblk, NT, 0, p.stream>>>(
        p, j, a, ld0, b, ld1, c, ld2);
  else
    lanczos_sum_kernel<T, VEC, true><<<p.nblk, NT, 0, p.stream>>>(
        p, j, a, ld0, b, ld1, c, ld2);
  return done();
}

template <typename T, int VEC>
void project_launch(const Plan& p, int j, int slots) {
  if (slots == 4)
    lanczos_project_kernel<T, VEC, 4><<<p.nblk, NT, 0, p.stream>>>(p, j);
  else if (slots == 8)
    lanczos_project_kernel<T, VEC, 8><<<p.nblk, NT, 0, p.stream>>>(p, j);
  else
    lanczos_project_kernel<T, VEC, 12><<<p.nblk, NT, 0, p.stream>>>(p, j);
}

template <typename T, int VEC>
int normalize_launch(const Plan& p, const void* src, const void* beta,
                     void* qn) {
  const T* s = static_cast<const T*>(src);
  const T* b = static_cast<const T*>(beta);
  T* q = static_cast<T*>(qn);
  switch (p.op_dtype) {
    case NONE:
      lanczos_normalize_kernel<T, VEC, NoOperand><<<p.nblk, NT, 0, p.stream>>>(p, s, b, q);
      break;
    case BF16:
      if constexpr (std::is_same<T, float>::value)
        lanczos_normalize_kernel<T, VEC, __nv_bfloat16><<<p.nblk, NT, 0, p.stream>>>(p, s, b, q);
      else
        return static_cast<int>(cudaErrorInvalidValue);
      break;
    default:
      lanczos_normalize_kernel<T, VEC, T><<<p.nblk, NT, 0, p.stream>>>(p, s, b, q);
  }
  return done();
}

size_t esize_of(int dtype) { return dtype == F64 ? 8 : dtype == BF16 ? 2 : 4; }

int init_plan(Plan& p, int dtype, int op_dtype, long long Kp,
              long long nrows, int D, int m, double scale, void* stream) {
  p = Plan{};
  if ((dtype != F32 && dtype != F64) || Kp <= 0 || D <= 0 || m <= 0 ||
      nrows < Kp || (op_dtype != NONE && op_dtype != dtype &&
                     !(dtype == F32 && op_dtype == BF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec = vec_of(dtype, D);
  if (p.vec == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.dtype = dtype;
  p.op_dtype = op_dtype;
  p.Kp = Kp;
  p.nrows = nrows;
  p.D = D;
  p.m = m;
  p.scale = scale;
  p.stream = static_cast<cudaStream_t>(stream);
  return set_grid(p);
}

}  // namespace

extern "C" {

// The kernels launched so far by this library's launch calls.
long long lanczos_launches() { return launched; }

// Bytes of the host-side plan a caller keeps for one lanczos_tridiag call.
int lanczos_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// Fill a plan: T's code (0 float32, 1 float64), the split form's operand
// code (0 float32, 1 float64, 2 bfloat16 with float32 T; -1 generic form),
// the shapes (operands of nrows >= Kp rows), the operator's scale and the
// stream.  sizes[0] gets the elements of T the partials need, sizes[1] the
// int32 counters (zeroed by the caller).  Returns 0 or cudaErrorInvalidValue
// for shapes or types it does not take.
int lanczos_plan_init(void* plan, int dtype, int op_dtype, long long Kp,
                      long long nrows, int D, int m, double scale,
                      void* stream, long long* sizes) {
  Plan& p = *static_cast<Plan*>(plan);
  const int e = init_plan(p, dtype, op_dtype, Kp, nrows, D, m, scale, stream);
  if (e != 0) return e;
  sizes[0] = static_cast<long long>(p.nblk + p.ngroups) * m * D;
  sizes[1] = p.ngroups + 1;
  return 0;
}

// The buffers of a plan: basis [m, Kp, D], coefs [3m + 1, D] (alphas,
// betas, projections, beta0), work [2 Kp D + sizes[0]] (w, w3, partials),
// counters [sizes[1]] zeroed; split form: d, h [Kp] and the operands
// [nrows, D] (null in the generic form).
int lanczos_plan_bind(void* plan, void* basis, void* coefs, void* work,
                      void* counters, const void* d, const void* h,
                      void* op_q, void* op_hq) {
  Plan& p = *static_cast<Plan*>(plan);
  const size_t es = esize_of(p.dtype), KD = static_cast<size_t>(p.Kp) * p.D;
  char* wk = static_cast<char*>(work);
  p.basis = basis;
  p.coefs = coefs;
  p.w = wk;
  p.w3 = wk + KD * es;
  p.part = wk + 2 * KD * es;
  p.gpart = wk + (2 * KD + static_cast<size_t>(p.nblk) * p.m * p.D) * es;
  p.counters = static_cast<unsigned*>(counters);
  p.d = d;
  p.h = h;
  p.op_q = op_q;
  p.op_hq = op_hq;
  const uintptr_t all = reinterpret_cast<uintptr_t>(basis) |
                        reinterpret_cast<uintptr_t>(coefs) |
                        reinterpret_cast<uintptr_t>(work) |
                        reinterpret_cast<uintptr_t>(op_q) |
                        reinterpret_cast<uintptr_t>(op_hq);
  if (p.op_dtype != NONE && (!d || !h || !op_q || !op_hq))
    return static_cast<int>(cudaErrorInvalidValue);
  return all % 16 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// The start: beta0 = the column norms of V [Kp, D] (contiguous), then
// q0 = V / beta0 into slot 0 (and its operands).  Two launches.
int lanczos_start_launch(const void* plan, const void* V) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const size_t es = esize_of(p.dtype);
  const bool vec = p.vec > 1 && aligned(V, p.D, static_cast<int>(es));
  if (!vec && p.D > NT) return static_cast<int>(cudaErrorInvalidValue);
  const void* beta0 = static_cast<const char*>(p.coefs) + 3 * static_cast<size_t>(p.m) * p.D * es;
  int e;
  if (p.dtype == F64) {
    const double* v = static_cast<const double*>(V);
    if (vec) lanczos_subtract_kernel<double, 2, true><<<p.nblk, NT, 0, p.stream>>>(p, 0, 0, v);
    else lanczos_subtract_kernel<double, 1, true><<<p.nblk, NT, 0, p.stream>>>(p, 0, 0, v);
    if ((e = done())) return e;
    return vec ? normalize_launch<double, 2>(p, V, beta0, p.basis)
               : normalize_launch<double, 1>(p, V, beta0, p.basis);
  }
  const float* v = static_cast<const float*>(V);
  if (vec) lanczos_subtract_kernel<float, 4, true><<<p.nblk, NT, 0, p.stream>>>(p, 0, 0, v);
  else lanczos_subtract_kernel<float, 1, true><<<p.nblk, NT, 0, p.stream>>>(p, 0, 0, v);
  if ((e = done())) return e;
  return vec ? normalize_launch<float, 4>(p, V, beta0, p.basis)
             : normalize_launch<float, 1>(p, V, beta0, p.basis);
}

// Pass A of step j: P0 (generic) or P0, P1, P2 = the products of q's
// operands by Q, S~ and S~T (split), each with its row stride.
int lanczos_sum_launch(const void* plan, int j, const void* P0, long long ld0,
                       const void* P1, long long ld1, const void* P2,
                       long long ld2) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const int es = static_cast<int>(esize_of(p.dtype));
  bool vec = p.vec > 1 && aligned(P0, ld0, es);
  if (p.op_dtype != NONE) vec = vec && aligned(P1, ld1, es) && aligned(P2, ld2, es);
  if (!vec && p.D > NT) return static_cast<int>(cudaErrorInvalidValue);
  if (p.dtype == F64)
    return vec ? sum_launch<double, 2>(p, j, P0, ld0, P1, ld1, P2, ld2)
               : sum_launch<double, 1>(p, j, P0, ld0, P1, ld1, P2, ld2);
  return vec ? sum_launch<float, 4>(p, j, P0, ld0, P1, ld1, P2, ld2)
             : sum_launch<float, 1>(p, j, P0, ld0, P1, ld1, P2, ld2);
}

// Pass B of step j.
int lanczos_project_launch(const void* plan, int j) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const int slots = j < 4 ? 4 : j < 8 ? 8 : 12;
  if (p.dtype == F64) {
    if (p.vec > 1) project_launch<double, 2>(p, j, slots);
    else project_launch<double, 1>(p, j, slots);
  } else {
    if (p.vec > 1) project_launch<float, 4>(p, j, slots);
    else project_launch<float, 1>(p, j, slots);
  }
  return done();
}

// Pass C of step j against the projections on slots 0..nslots-1 (j + 1
// with re-orthogonalisation, 0 without).
int lanczos_subtract_launch(const void* plan, int j, int nslots) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.dtype == F64) {
    if (p.vec > 1) lanczos_subtract_kernel<double, 2, false><<<p.nblk, NT, 0, p.stream>>>(p, j, nslots, nullptr);
    else lanczos_subtract_kernel<double, 1, false><<<p.nblk, NT, 0, p.stream>>>(p, j, nslots, nullptr);
  } else {
    if (p.vec > 1) lanczos_subtract_kernel<float, 4, false><<<p.nblk, NT, 0, p.stream>>>(p, j, nslots, nullptr);
    else lanczos_subtract_kernel<float, 1, false><<<p.nblk, NT, 0, p.stream>>>(p, j, nslots, nullptr);
  }
  return done();
}

// Pass D of step j (j + 1 < m): q_{j+1} into slot j + 1.
int lanczos_normalize_launch(const void* plan, int j) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const size_t es = esize_of(p.dtype), KD = static_cast<size_t>(p.Kp) * p.D;
  const void* beta = static_cast<const char*>(p.coefs) + (static_cast<size_t>(p.m) + j) * p.D * es;
  void* qn = static_cast<char*>(p.basis) + (j + 1) * KD * es;
  if (p.dtype == F64)
    return p.vec > 1 ? normalize_launch<double, 2>(p, p.w3, beta, qn)
                     : normalize_launch<double, 1>(p, p.w3, beta, qn);
  return p.vec > 1 ? normalize_launch<float, 4>(p, p.w3, beta, qn)
                   : normalize_launch<float, 1>(p, p.w3, beta, qn);
}

// F [Kp, D] = sum_i coeff[:, i] * Q_i over the m slots of a basis
// [m, Kp, D] of T's code dtype (coeff [D, m]; all contiguous).  One launch.
int lanczos_combine_launch(int dtype, const void* basis, const void* coeff,
                           void* F, long long Kp, int D, int m,
                           void* stream) {
  Plan p;
  int e = init_plan(p, dtype, NONE, Kp, Kp, D, m, 1.0, stream);
  if (e != 0) return e;
  p.basis = const_cast<void*>(basis);
  const int es = static_cast<int>(esize_of(p.dtype));
  const bool vec = p.vec > 1 && aligned(F, p.D, es) && aligned(basis, p.D, es);
  if (!vec && p.D > NT) return static_cast<int>(cudaErrorInvalidValue);
  if (p.dtype == F64) {
    const double* c = static_cast<const double*>(coeff);
    double* f = static_cast<double*>(F);
    if (vec) lanczos_combine_kernel<double, 2><<<p.nblk, NT, 0, p.stream>>>(p, c, f);
    else lanczos_combine_kernel<double, 1><<<p.nblk, NT, 0, p.stream>>>(p, c, f);
  } else {
    const float* c = static_cast<const float*>(coeff);
    float* f = static_cast<float*>(F);
    if (vec) lanczos_combine_kernel<float, 4><<<p.nblk, NT, 0, p.stream>>>(p, c, f);
    else lanczos_combine_kernel<float, 1><<<p.nblk, NT, 0, p.stream>>>(p, c, f);
  }
  return done();
}

}  // extern "C"
