// Fused LogDetDiversity / MutualInformationGaussian chunk-accept sweep on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logdet_accept.py,
// logdet_accept (body _la_kernel), in both of its modes: cardinality
// (cost=None) and knapsack cost (a (B,) row-cost vector and a remaining
// budget, the rule of accept_sweep.cuh).  One launch serves L lanes, one
// CTA each, in place of the JAX engines' vmap over the tau grid.
//
// Per lane: the whitened basis U (k, d) lives in shared memory for the
// whole sweep.  Rows are taken in stream order; for row i
//   1. v_j = alpha <U_j, x_i> over the live rows j < min(size0 + n_acc, k);
//   2. ||x_i||^2;
//   3. d2 = max(1 + alpha ||x_i||^2 - sum_j v_j^2, eps);
//   4. gain = scale * log d2 (scale = 0.5 is mutual information);
//   5. accept iff eligible && gain >= tau && n_acc < budget, or, in the
//      cost mode, iff eligible && gain >= tau * c_i && n_acc < budget &&
//      spent + c_i <= cost_budget, spent the f32 sum of the accepted
//      costs in row order (the JAX kernel's carry, each step rounded on
//      its own);
//   6. on accept, U[size0 + n_acc] = (x_i - sum_j v_j U_j) / sqrt(d2) and
//      logdet += gain.  An append at row k (or past it) writes no row, as
//      the JAX kernel's masked select writes none; logdet and size still
//      move, as there.
// Outputs: mask (L, B) bool, U (L, k, d), logdet (L,), size (L,) int32 and
// each row's gain at scan time (L, B) f32.
//
// Rows of U at or past the lane's size are zero (the oracle's invariant:
// they start at zero and an append writes row size), so step 1 and the
// append skip them: their exact 0.0 products would change no bit.
//
// What bounds it on the H100: at L = 37, B = 128, k = 64, d = 256 the bytes
// (4.8 MB of rows, 2 x 2.4 MB of U) take about 3 us at 3.35 TB/s, and the
// live rows' products fewer operations still; the real cost is the chain of
// B dependent steps, each a k x d matvec, a reduction and, on accept, a
// d x k update.  The design keeps that chain on chip: U in dynamic shared
// memory (64 KiB at k = 64, d = 256), one warp per dot product
// (<U_j, x_i> and ||x_i||^2 spread over the CTA's 8 warps), row i + 1
// loaded while row i is scored, and two barriers per row.  Every thread
// sums the v_j^2 in the same order, so all hold the bit-identical gain and
// take the same decision; no atomics, so a repeated launch gives the same
// bits.  Only L of the card's 132 SMs are busy.
//
// The wide instance (kWide, picked by the wrapper when U and the two staged
// rows outgrow the 227 KiB a block may use: k = 64 at d = 1024, or
// k = d = 256): U lives in the lane's (k, d) slice of U_out, copied there
// from U_in first and appended in place (37 x 64 x 1024 x 4 B = 9.7 MB,
// resident in the 50 MB L2), rows are read from x where they lie, and only
// the k + 1 dot products stay in shared memory.  The same warps compute
// the same sums in the same order, so the wide instance gives the bits the
// narrow one would; __syncthreads also orders the global appends.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  float alpha, scale, eps;
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Row i of a lane: staged in shared memory (narrow) or read from x where
// it lies (wide), widened to f32 either way.
template <typename T, bool kWide>
struct Row {
  const float* staged;
  const T* row;
  __device__ __forceinline__ float operator[](int f) const {
    if constexpr (kWide) return load_f(row + f);
    else return staged[f];
  }
};

template <typename T, bool kCost, bool kWide>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ x, const float* __restrict__ U_in,
       const float* __restrict__ logdet_in, const int* __restrict__ size_in,
       const unsigned char* __restrict__ eligible,
       const float* __restrict__ tau, const int* __restrict__ budget,
       const float* __restrict__ cost, const float* __restrict__ cost_budget,
       unsigned char* __restrict__ mask, float* __restrict__ U_out,
       float* __restrict__ logdet_out, int* __restrict__ size_out,
       float* __restrict__ gains, int B, int k, int d, Params p) {
  extern __shared__ float smem[];
  const int l = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xl = x + (long long)l * B * d;
  const long long u0 = (long long)l * k * d;
  // narrow: U [k][d], then rows i and i + 1 [2][d], in shared memory;
  // wide: U is the lane's slice of U_out.  dots [k + 1]: <U_j, x_i>, then
  // ||x_i||^2
  float* Us = kWide ? U_out + u0 : smem;
  float* xs = kWide ? nullptr : smem + k * d;
  float* dots = kWide ? smem : xs + 2 * d;
  for (int t = threadIdx.x; t < k * d; t += kThreads) Us[t] = U_in[u0 + t];
  if (!kWide && B > 0)
    for (int f = threadIdx.x; f < d; f += kThreads) xs[f] = load_f(xl + f);
  const int size0 = size_in[l];
  const float tau_l = tau[l];
  const int budget_l = budget[l];
  float ld = logdet_in[l];
  int n_acc = 0;
  const float cbud = kCost ? cost_budget[l] : 0.0f;
  float spent = 0.0f;
  for (int i = 0; i < B; ++i) {
    const Row<T, kWide> xc{kWide ? nullptr : xs + (i & 1) * d,
                           xl + (long long)i * d};
    // row i staged, the last append written, the last row's dots read
    __syncthreads();
    const int live = min(max(size0 + n_acc, 0), k);
    for (int task = warp; task <= live; task += kWarps) {
      float s = 0.0f;
      if (task < live) {
        const float* uj = Us + task * d;
        for (int f = lane; f < d; f += 32) s = fmaf(uj[f], xc[f], s);
      } else {
        for (int f = lane; f < d; f += 32)
          s = __fadd_rn(s, __fmul_rn(xc[f], xc[f]));
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) dots[task < live ? task : k] = s;
    }
    if (!kWide && i + 1 < B)
      for (int f = threadIdx.x; f < d; f += kThreads)
        xs[((i + 1) & 1) * d + f] = load_f(xl + (long long)(i + 1) * d + f);
    __syncthreads();
    float vv = 0.0f;
    for (int j = 0; j < live; ++j) {
      const float v = __fmul_rn(p.alpha, dots[j]);
      vv = __fadd_rn(vv, __fmul_rn(v, v));
    }
    const float d2 = fmaxf(
        __fsub_rn(__fadd_rn(1.0f, __fmul_rn(p.alpha, dots[k])), vv), p.eps);
    float g = logf(d2);
    if (p.scale != 1.0f) g = __fmul_rn(p.scale, g);
    bool acc;
    if constexpr (kCost) {
      const float c = cost[(long long)l * B + i];
      acc = eligible[(long long)l * B + i] && g >= __fmul_rn(tau_l, c) &&
            n_acc < budget_l && __fadd_rn(spent, c) <= cbud;
      if (acc) spent = __fadd_rn(spent, c);
    } else {
      acc = eligible[(long long)l * B + i] && g >= tau_l && n_acc < budget_l;
    }
    if (acc) {
      const int row = size0 + n_acc;
      if (row >= 0 && row < k) {
        const float rd = sqrtf(d2);
        for (int f = threadIdx.x; f < d; f += kThreads) {
          float s = 0.0f;
          for (int j = 0; j < live; ++j)
            s = fmaf(__fmul_rn(p.alpha, dots[j]), Us[j * d + f], s);
          Us[row * d + f] = __fdiv_rn(__fsub_rn(xc[f], s), rd);
        }
      }
      ld = __fadd_rn(ld, g);
      ++n_acc;
    }
    if (threadIdx.x == 0) {
      mask[(long long)l * B + i] = acc ? 1 : 0;
      gains[(long long)l * B + i] = g;
    }
  }
  if (!kWide) {
    __syncthreads();
    for (int t = threadIdx.x; t < k * d; t += kThreads) U_out[u0 + t] = Us[t];
  }
  if (threadIdx.x == 0) {
    logdet_out[l] = ld;
    size_out[l] = size0 + n_acc;
  }
}

template <typename T, bool kCost, bool kWide>
cudaError_t launch_mode(const void* x, const void* U, const void* logdet,
                        const void* size, const void* eligible,
                        const void* tau, const void* budget, const void* cost,
                        const void* cost_budget, void* mask, void* U_out,
                        void* logdet_out, void* size_out, void* gains, int L,
                        int B, int k, int d, const Params& p, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel<T, kCost, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<T, kCost, kWide><<<L, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(U),
      static_cast<const float*>(logdet), static_cast<const int*>(size),
      static_cast<const unsigned char*>(eligible),
      static_cast<const float*>(tau), static_cast<const int*>(budget),
      static_cast<const float*>(cost), static_cast<const float*>(cost_budget),
      static_cast<unsigned char*>(mask), static_cast<float*>(U_out),
      static_cast<float*>(logdet_out), static_cast<int*>(size_out),
      static_cast<float*>(gains), B, k, d, p);
  return cudaGetLastError();
}

// cost (L, B) f32 and cost_budget (L,) f32 select the knapsack cost mode,
// nullptr the cardinality mode.
template <typename T, bool kWide>
cudaError_t launch(const void* x, const void* U, const void* logdet,
                   const void* size, const void* eligible, const void* tau,
                   const void* budget, const void* cost,
                   const void* cost_budget, void* mask, void* U_out,
                   void* logdet_out, void* size_out, void* gains, int L,
                   int B, int k, int d, const Params& p, size_t smem,
                   cudaStream_t stream) {
  return cost
      ? launch_mode<T, true, kWide>(x, U, logdet, size, eligible, tau, budget,
                                    cost, cost_budget, mask, U_out,
                                    logdet_out, size_out, gains, L, B, k, d,
                                    p, smem, stream)
      : launch_mode<T, false, kWide>(x, U, logdet, size, eligible, tau,
                                     budget, cost, cost_budget, mask, U_out,
                                     logdet_out, size_out, gains, L, B, k, d,
                                     p, smem, stream);
}

template <typename T>
cudaError_t launch_dtype(const void* x, const void* U, const void* logdet,
                         const void* size, const void* eligible,
                         const void* tau, const void* budget,
                         const void* cost, const void* cost_budget,
                         void* mask, void* U_out, void* logdet_out,
                         void* size_out, void* gains, int L, int B, int k,
                         int d, const Params& p, int wide, size_t smem,
                         cudaStream_t stream) {
  return wide
      ? launch<T, true>(x, U, logdet, size, eligible, tau, budget, cost,
                        cost_budget, mask, U_out, logdet_out, size_out, gains,
                        L, B, k, d, p, smem, stream)
      : launch<T, false>(x, U, logdet, size, eligible, tau, budget, cost,
                         cost_budget, mask, U_out, logdet_out, size_out,
                         gains, L, B, k, d, p, smem, stream);
}

}  // namespace

// wide: the instance the wrapper picked (logdet_accept.instance): 0 keeps
// U in shared memory, 1 in U_out.
extern "C" int logdet_accept_launch(
    const void* x, int x_is_bf16, const void* U, const void* logdet,
    const void* size, const void* eligible, const void* tau,
    const void* budget, const void* cost, const void* cost_budget,
    void* mask, void* U_out, void* logdet_out, void* size_out, void* gains,
    int L, int B, int k, int d, float alpha, float scale, float eps, int wide,
    void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  // narrow: U, two staged rows and the k + 1 dot products; wide: the dot
  // products alone
  const long long smem =
      ((wide ? 0LL : (long long)k * d + 2LL * d) + k + 1) * 4;
  if (k <= 0 || d <= 0 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const Params p{alpha, scale, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16
      ? launch_dtype<__nv_bfloat16>(x, U, logdet, size, eligible, tau, budget,
                                    cost, cost_budget, mask, U_out,
                                    logdet_out, size_out, gains, L, B, k, d, p,
                                    wide, (size_t)smem, s)
      : launch_dtype<float>(x, U, logdet, size, eligible, tau, budget, cost,
                            cost_budget, mask, U_out, logdet_out, size_out,
                            gains, L, B, k, d, p, wide, (size_t)smem, s));
}
