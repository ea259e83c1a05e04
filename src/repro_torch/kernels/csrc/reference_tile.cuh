// The reference-set kernels of FacilityLocation and ExemplarClustering
// (facility_accept.cu and exemplar_accept.cu, and, through
// marginals_tile.cuh, facility_marginals.cu and exemplar_marginals.cu): a
// candidate block against a replicated (r, d) reference set, with the
// oracle's epilogue and residual supplied by a Rule.  The sweep's product
// is the tile of sims_tile.cuh; the marginals have their own Hopper tile
// with the same fmaf chains (marginals_tile.cuh).
//
//   marginals:  out[l, i] = sum_j Rule::residual(s[l, j], v(i, j))
//   sweep:      gain_i    = sum_j Rule::residual(s_j, v(i, j)),
//               accepted:   s_j = Rule::update(s_j, v(i, j))
//
// with v(i, j) the Rule's tile value of the product acc = <cand_i, ref_j>:
//
//   Facility:  v = max(acc, 0) (the tile rectifies), residual max(v - s, 0),
//              update max(s, v);
//   Exemplar:  v = d2 = max((refsq_j - 2 acc) + sq_i, 0), residual
//              max(s - v, 0), update min(s, v).
//
// Exemplar keeps the JAX package's order of the three distance terms
// (src/repro/kernels/exemplar_marginals.py, _ex_kernel), each step rounded
// on its own (__fmul_rn, __fsub_rn, __fadd_rn, no contraction into an fma),
// so dyadic data stays exact.  The terms nearly cancel at the deployment's
// widths (||r||^2 ~ 85, 2 <c, r> ~ 128, ||c||^2 ~ 85 at d = 256), which is
// why the order is kept.  refsq_j = ||ref_j||^2 is one f32 (r,) vector the
// wrapper computes; sq_i = ||cand_i||^2, the row at its storage dtype
// widened to f32, is computed by row_sq in one fixed order, so the
// marginals and the sweep see the same bits for the same row.
//
// The sweep (the notes on what bounds it are in the .cu files): one CTA per
// lane.  Phase 1 writes the lane's (B, r) value block to an (L, B, r) f32
// workspace the wrapper allocates (a (B, r) block outgrows shared memory at
// r = 1024); phase 2 is a Step on run_sweep (accept_sweep.cuh) that reads
// the block back row by row.  Thread t owns columns t, t + 256, ..., so an
// accept is a thread-local update.  Two instances of phase 2, picked by
// the wrapper from r: the narrow one (r <= 4096) holds the state in
// registers and loads row i + 1 while row i is reduced; the wide one holds
// it in the lane's row of state_out, so no r is refused.
// Ragged rows (past C or B) and columns (past r) are masked, not padded (the
// JAX kernels pad the state with -inf or +inf).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "accept_sweep.cuh"
#include "sims_tile.cuh"

namespace reftile {

constexpr int kThreads = sims::kThreads;
constexpr int kSqParts = kThreads / sims::kTileRows;  // row_sq: 4 x 64 rows

// sq[i] = ||cand[row0 + i]||^2 for the kTileRows rows of a tile (0 past C).
// Thread t sums columns k = t % 4, t % 4 + 4, ... of row t / 4, then one
// thread per row adds the four partials left to right.  ``part`` is
// kThreads floats of shared scratch.  Every thread of the CTA must call it;
// it ends with a barrier.
template <typename TC>
__device__ __forceinline__ void row_sq(const TC* __restrict__ cand,
                                       long long C, int d, long long row0,
                                       float* part, float* sq) {
  const int i = threadIdx.x / kSqParts, q = threadIdx.x % kSqParts;
  const long long row = row0 + i;
  float s = 0.0f;
  if (row < C)
    for (int k = q; k < d; k += kSqParts) {
      const float v = sims::to_f(cand[row * d + k]);
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < sims::kTileRows) {
    float t = part[threadIdx.x * kSqParts];
#pragma unroll
    for (int p = 1; p < kSqParts; ++p)
      t = __fadd_rn(t, part[threadIdx.x * kSqParts + p]);
    sq[threadIdx.x] = t;
  }
  __syncthreads();
}

struct Facility {
  static constexpr bool kRectify = true;    // sims::tile takes max(acc, 0)
  static constexpr bool kRowNorms = false;  // needs no sq
  const float* refsq;                       // unused
  __device__ __forceinline__ float value(float acc, int, float) const {
    return acc;
  }
  static __device__ __forceinline__ float residual(float s, float v) {
    return fmaxf(v - s, 0.0f);
  }
  static __device__ __forceinline__ float update(float s, float v) {
    return fmaxf(s, v);
  }
};

struct Exemplar {
  static constexpr bool kRectify = false;
  static constexpr bool kRowNorms = true;
  const float* refsq;  // (r,) ||ref_j||^2
  __device__ __forceinline__ float value(float acc, int col, float sq) const {
    return fmaxf(__fadd_rn(__fsub_rn(__ldg(refsq + col), __fmul_rn(2.0f, acc)),
                           sq),
                 0.0f);
  }
  static __device__ __forceinline__ float residual(float s, float v) {
    return fmaxf(s - v, 0.0f);
  }
  static __device__ __forceinline__ float update(float s, float v) {
    return fminf(s, v);
  }
};

// The squared row norms a Rule needs (kRowNorms), in shared memory.
template <bool kRowNorms>
struct RowNorms {
  float sq[sims::kTileRows], part[kThreads];
  template <typename TC>
  __device__ void take(const TC* x, long long C, int d, long long row0) {
    row_sq(x, C, d, row0, part, sq);
  }
  __device__ float at(int i) const { return sq[i]; }
};
template <>
struct RowNorms<false> {
  template <typename TC>
  __device__ void take(const TC*, long long, int, long long) {}
  __device__ float at(int) const { return 0.0f; }
};

// acc[m][n] of a sims::tile at (row0, col0) as the Rule's values v(i, j),
// for the thread's kMicro x kMicro micro block (columns past r take column
// r - 1's norm; the callers never read them).
template <class Rule, typename TC>
__device__ __forceinline__ void tile_values(const Rule& rule, const TC* x,
                                            long long C, const float* ref,
                                            int r, int d, long long row0,
                                            int col0, sims::Stage& stage,
                                            const RowNorms<Rule::kRowNorms>& rn,
                                            float v[sims::kMicro][sims::kMicro]) {
  sims::tile<TC, Rule::kRectify>(x, C, ref, r, d, row0, col0, stage, v);
  const int mr = sims::micro_row(), mc = sims::micro_col();
#pragma unroll
  for (int n = 0; n < sims::kMicro; ++n) {
    const int c = min(col0 + mc + n, r - 1);
#pragma unroll
    for (int m = 0; m < sims::kMicro; ++m)
      v[m][n] = rule.value(v[m][n], c, rn.at(mr + m));
  }
}

// ----------------------------------------------------------------- sweep
template <class Rule, int kPer>
struct Step {
  const float* block;  // this lane's (B, r) value block in the workspace
  int B, r;
  float s[kPer], cur[kPer], next[kPer];

  // plain loads, not __ldg: the block was written earlier in this kernel
  __device__ void load_row(int i, float* dst) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = threadIdx.x + j * kThreads;
      dst[j] = (i < B && c < r) ? block[(long long)i * r + c] : 0.0f;
    }
  }

  __device__ float partial(int i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) cur[j] = next[j];
    load_row(i + 1, next);
    float p = 0.0f;
    // columns past r hold s = 0 and v = 0 and add exactly 0
#pragma unroll
    for (int j = 0; j < kPer; ++j) p += Rule::residual(s[j], cur[j]);
    return p;
  }

  __device__ void accept() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = Rule::update(s[j], cur[j]);
  }
};

// The wide instance's Step (r > 16 * kThreads = 4096): the state lives in
// this lane's row of state_out (global memory), each thread still owning
// columns t, t + 256, ..., so an accept needs no barrier.  It sums the same
// residuals in the same order as the narrow Step (whose columns past r add
// exactly 0), so it gives the bits the narrow one would.
template <class Rule>
struct WideStep {
  const float* block;  // this lane's (B, r) value block in the workspace
  float* s;            // this lane's (r,) state, in global memory
  int r, i;            // i: the row last scored

  __device__ float partial(int row) {
    i = row;
    const float* v = block + (long long)row * r;
    float p = 0.0f;
    for (int c = threadIdx.x; c < r; c += kThreads) p += Rule::residual(s[c], v[c]);
    return p;
  }

  __device__ void accept() {
    const float* v = block + (long long)i * r;
    for (int c = threadIdx.x; c < r; c += kThreads) s[c] = Rule::update(s[c], v[c]);
  }
};

// kPer: columns per thread of the narrow instance, or 0 for the wide one.
template <class Rule, typename TC, int kPer, bool kCost>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const TC* __restrict__ cand, const float* __restrict__ ref,
             Rule rule, const float* __restrict__ state,
             const unsigned char* __restrict__ eligible,
             const float* __restrict__ tau, const int* __restrict__ budget,
             const float* __restrict__ cost,
             const float* __restrict__ cost_budget,
             unsigned char* __restrict__ mask, float* __restrict__ state_out,
             float* __restrict__ gains, float* work, int B, int r, int d) {
  __shared__ __align__(16) sims::Stage stage;
  __shared__ RowNorms<Rule::kRowNorms> rn;
  const int l = blockIdx.x;
  const TC* x = cand + (long long)l * B * d;
  float* block = work + (long long)l * B * r;

  // phase 1: the lane's value block
  const int mr = sims::micro_row(), mc = sims::micro_col();
  for (int row0 = 0; row0 < B; row0 += sims::kTileRows) {
    rn.take(x, B, d, row0);
    for (int col0 = 0; col0 < r; col0 += sims::kTileCols) {
      float v[sims::kMicro][sims::kMicro];
      tile_values(rule, x, B, ref, r, d, row0, col0, stage, rn, v);
#pragma unroll
      for (int m = 0; m < sims::kMicro; ++m)
#pragma unroll
        for (int n = 0; n < sims::kMicro; ++n) {
          const int i = row0 + mr + m, c = col0 + mc + n;
          if (i < B && c < r) block[(long long)i * r + c] = v[m][n];
        }
    }
  }
  __syncthreads();   // the block is visible to every thread of the CTA

  // phase 2: the sweep
  const float* cost_l = kCost ? cost + (long long)l * B : nullptr;
  const float cbud = kCost ? cost_budget[l] : 0.0f;
  if constexpr (kPer == 0) {
    WideStep<Rule> step{block, state_out + (long long)l * r, r, 0};
    for (int c = threadIdx.x; c < r; c += kThreads)
      step.s[c] = state[(long long)l * r + c];
    run_sweep<kThreads, kCost>(step, B, eligible + (long long)l * B, tau[l],
                               budget[l], cost_l, cbud,
                               mask + (long long)l * B,
                               gains + (long long)l * B);
  } else {
    Step<Rule, kPer> step;
    step.block = block;
    step.B = B;
    step.r = r;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = threadIdx.x + j * kThreads;
      step.s[j] = c < r ? state[(long long)l * r + c] : 0.0f;
    }
    step.load_row(0, step.next);
    run_sweep<kThreads, kCost>(step, B, eligible + (long long)l * B, tau[l],
                               budget[l], cost_l, cbud,
                               mask + (long long)l * B,
                               gains + (long long)l * B);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < r) state_out[(long long)l * r + c] = step.s[j];
    }
  }
}

template <class Rule, typename TC, int kPer>
cudaError_t launch_sweep_per(const void* cand, const void* ref,
                             const Rule& rule, const void* state,
                             const void* eligible, const void* tau,
                             const void* budget, const void* cost,
                             const void* cost_budget, void* mask,
                             void* state_out, void* gains, void* work, int L,
                             int B, int r, int d, cudaStream_t stream) {
  const TC* c = static_cast<const TC*>(cand);
  const float* rf = static_cast<const float*>(ref);
  const float* st = static_cast<const float*>(state);
  const unsigned char* el = static_cast<const unsigned char*>(eligible);
  const float* ta = static_cast<const float*>(tau);
  const int* bu = static_cast<const int*>(budget);
  const float* co = static_cast<const float*>(cost);
  const float* cb = static_cast<const float*>(cost_budget);
  unsigned char* ma = static_cast<unsigned char*>(mask);
  float* so = static_cast<float*>(state_out);
  float* ga = static_cast<float*>(gains);
  float* wo = static_cast<float*>(work);
  if (co)
    sweep_kernel<Rule, TC, kPer, true><<<L, kThreads, 0, stream>>>(
        c, rf, rule, st, el, ta, bu, co, cb, ma, so, ga, wo, B, r, d);
  else
    sweep_kernel<Rule, TC, kPer, false><<<L, kThreads, 0, stream>>>(
        c, rf, rule, st, el, ta, bu, co, cb, ma, so, ga, wo, B, r, d);
  return cudaGetLastError();
}

// per: the instance the wrapper picked (kernels/_wrap.py,
// reference_sweep_per): columns per thread of the narrow instance (1, 2,
// 4, 8 or 16, with r <= per * kThreads), or 0 for the wide instance.
template <class Rule, typename TC>
cudaError_t launch_sweep_dtype(const void* cand, const void* ref,
                               const Rule& rule, const void* state,
                               const void* eligible, const void* tau,
                               const void* budget, const void* cost,
                               const void* cost_budget, void* mask,
                               void* state_out, void* gains, void* work,
                               int L, int B, int r, int d, int per,
                               cudaStream_t stream) {
  if (per > 0 && r > per * kThreads) return cudaErrorInvalidValue;
#define REPRO_SWEEP_CASE(P)                                                  \
  case P:                                                                    \
    return launch_sweep_per<Rule, TC, P>(cand, ref, rule, state, eligible,   \
                                         tau, budget, cost, cost_budget,     \
                                         mask, state_out, gains, work, L, B, \
                                         r, d, stream);
  switch (per) {
    REPRO_SWEEP_CASE(0)
    REPRO_SWEEP_CASE(1)
    REPRO_SWEEP_CASE(2)
    REPRO_SWEEP_CASE(4)
    REPRO_SWEEP_CASE(8)
    REPRO_SWEEP_CASE(16)
  }
#undef REPRO_SWEEP_CASE
  return cudaErrorInvalidValue;
}

// Launch L lane sweeps, one CTA each: cand (L, B, d) f32 or bf16, ref (r, d)
// f32, state (L, r) f32, eligible (L, B) bool, tau (L,) f32, budget (L,)
// int32; cost (L, B) f32 and cost_budget (L,) f32 select the knapsack cost
// mode, nullptr the cardinality mode; work (L, B, r) f32 scratch; per the
// instance (see launch_sweep_dtype).
template <class Rule>
cudaError_t launch_sweep(const void* cand, int cand_is_bf16, const void* ref,
                         const Rule& rule, const void* state,
                         const void* eligible, const void* tau,
                         const void* budget, const void* cost,
                         const void* cost_budget, void* mask,
                         void* state_out, void* gains, void* work, int L,
                         int B, int r, int d, int per, cudaStream_t stream) {
  if (L <= 0 || r <= 0) return cudaSuccess;
  return cand_is_bf16
      ? launch_sweep_dtype<Rule, __nv_bfloat16>(
            cand, ref, rule, state, eligible, tau, budget, cost, cost_budget,
            mask, state_out, gains, work, L, B, r, d, per, stream)
      : launch_sweep_dtype<Rule, float>(
            cand, ref, rule, state, eligible, tau, budget, cost, cost_budget,
            mask, state_out, gains, work, L, B, r, d, per, stream);
}

}  // namespace reftile
