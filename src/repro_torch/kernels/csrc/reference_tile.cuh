// The reference-set kernels of FacilityLocation and ExemplarClustering
// (facility_marginals.cu, facility_accept.cu, exemplar_marginals.cu,
// exemplar_accept.cu): a candidate block against a replicated (r, d)
// reference set through the product tile of sims_tile.cuh, with the oracle's
// epilogue and residual supplied by a Rule.
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
// Designs (the notes on what bounds each kernel are in the .cu files):
//  * marginals: a CTA owns 64 candidate rows and a group of up to
//    kMaxLaneGroup lanes (one lane when the block is per lane) and walks
//    the r columns in 64-wide tiles.  Each tile's values land in shared
//    memory beside the lanes' 64-column state slice; the threads then
//    re-map onto (lane, 4 rows) quads that add the tile's residuals into a
//    per-(lane, row) sum the same thread owns for the whole kernel, so each
//    output is written once, with no float atomics, and a repeated launch
//    gives the same bits.  A wider grid is split into lane groups, each
//    recomputing the product.
//  * sweep: one CTA per lane.  Phase 1 writes the lane's (B, r) value block
//    to an (L, B, r) f32 workspace the wrapper allocates (a (B, r) block
//    outgrows shared memory at r = 1024); phase 2 is a Step on run_sweep
//    (accept_sweep.cuh) that streams the block back one row ahead of the
//    sweep, with the state in registers: thread t owns columns t, t + 256,
//    ..., so an accept is a thread-local update.
// Ragged rows (past C or B) and columns (past r) are masked, not padded (the
// JAX kernels pad the state with -inf or +inf).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "accept_sweep.cuh"
#include "sims_tile.cuh"

namespace reftile {

constexpr int kThreads = sims::kThreads;
constexpr int kMaxLaneGroup = 128;
constexpr int kQuadRows = sims::kTileRows / 4;   // a quad is rows i + 16m
constexpr int kSPitch = sims::kTileCols + 1;     // padded rows: no bank conflicts
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

// Bytes of dynamic shared memory the Rule's row norms take (none without).
template <class Rule>
__host__ __device__ constexpr size_t norms_bytes() {
  return Rule::kRowNorms ? sizeof(RowNorms<true>) : 0;
}

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

// ------------------------------------------------------------- marginals
template <class Rule>
size_t marginals_smem_bytes(int lanes) {
  return sizeof(sims::Stage) + norms_bytes<Rule>() +
         sizeof(float) * ((size_t)sims::kTileRows * kSPitch +   // value tile
                          (size_t)lanes * kSPitch +             // state slice
                          (size_t)lanes * sims::kTileRows);     // sums
}

template <class Rule, typename TC>
__global__ void __launch_bounds__(kThreads)
marginals_kernel(const TC* __restrict__ cand, int cand_per_lane,
                 const float* __restrict__ ref, Rule rule,
                 const float* __restrict__ state, float* __restrict__ out,
                 int L, long long C, int r, int d, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sims::Stage& stage = *reinterpret_cast<sims::Stage*>(smem_raw);
  auto& rn = *reinterpret_cast<RowNorms<Rule::kRowNorms>*>(
      smem_raw + sizeof(sims::Stage));
  float* S = reinterpret_cast<float*>(smem_raw + sizeof(sims::Stage) +
                                      norms_bytes<Rule>());
  float* st = S + sims::kTileRows * kSPitch;   // [nl][kSPitch]
  float* sums = st + group * kSPitch;          // [nl][kTileRows]

  int l0, nl;
  const TC* x = cand;
  if (cand_per_lane) {
    l0 = blockIdx.y;
    nl = 1;
    x = cand + (long long)l0 * C * d;
  } else {
    l0 = blockIdx.y * group;
    nl = min(group, L - l0);
  }
  const long long row0 = (long long)blockIdx.x * sims::kTileRows;
  const int tid = threadIdx.x;
  for (int t = tid; t < nl * sims::kTileRows; t += kThreads) sums[t] = 0.0f;
  rn.take(x, C, d, row0);

  const int mr = sims::micro_row(), mc = sims::micro_col();
  for (int col0 = 0; col0 < r; col0 += sims::kTileCols) {
    float v[sims::kMicro][sims::kMicro];
    tile_values(rule, x, C, ref, r, d, row0, col0, stage, rn, v);
#pragma unroll
    for (int m = 0; m < sims::kMicro; ++m)
#pragma unroll
      for (int n = 0; n < sims::kMicro; ++n)
        S[(mr + m) * kSPitch + mc + n] = v[m][n];
    const int nc = min(sims::kTileCols, r - col0);
    for (int t = tid; t < nl * sims::kTileCols; t += kThreads) {
      const int l = t / sims::kTileCols, c = t % sims::kTileCols;
      st[l * kSPitch + c] =
          c < nc ? __ldg(state + (long long)(l0 + l) * r + col0 + c) : 0.0f;
    }
    __syncthreads();
    for (int q = tid; q < nl * kQuadRows; q += kThreads) {
      const int l = q / kQuadRows, i = q % kQuadRows;
      const float* sl = st + l * kSPitch;
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < nc; ++c) {
        const float s = sl[c];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          p[m] += Rule::residual(s, S[(i + kQuadRows * m) * kSPitch + c]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        sums[l * sims::kTileRows + i + kQuadRows * m] += p[m];
    }
    __syncthreads();   // S and st are rewritten by the next column tile
  }
  for (int t = tid; t < nl * sims::kTileRows; t += kThreads) {
    const int l = t / sims::kTileRows, i = t % sims::kTileRows;
    const long long row = row0 + i;
    if (row < C) out[(long long)(l0 + l) * C + row] = sums[t];
  }
}

template <class Rule, typename TC>
cudaError_t launch_marginals_dtype(const void* cand, int cand_per_lane,
                                   const void* ref, const Rule& rule,
                                   const void* state, void* out, int L,
                                   long long C, int r, int d,
                                   cudaStream_t stream) {
  const int group = cand_per_lane ? 1 : (L < kMaxLaneGroup ? L : kMaxLaneGroup);
  const size_t smem = marginals_smem_bytes<Rule>(group);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        marginals_kernel<Rule, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long row_tiles = (C + sims::kTileRows - 1) / sims::kTileRows;
  const int lane_blocks = cand_per_lane ? L : (L + group - 1) / group;
  if (row_tiles > 0x7fffffffLL || lane_blocks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, lane_blocks);
  marginals_kernel<Rule, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TC*>(cand), cand_per_lane,
      static_cast<const float*>(ref), rule, static_cast<const float*>(state),
      static_cast<float*>(out), L, C, r, d, group);
  return cudaGetLastError();
}

// Launch the marginals of cand (C, d) shared or (L, C, d) per lane, f32 or
// bf16, against ref (r, d) f32 and state (L, r) f32 into out (L, C) f32.
template <class Rule>
cudaError_t launch_marginals(const void* cand, int cand_is_bf16,
                             int cand_per_lane, const void* ref,
                             const Rule& rule, const void* state, void* out,
                             int L, long long C, int r, int d,
                             cudaStream_t stream) {
  if (L <= 0 || C <= 0) return cudaSuccess;
  if (r <= 0 || d < 0) return cudaErrorInvalidValue;
  return cand_is_bf16
      ? launch_marginals_dtype<Rule, __nv_bfloat16>(
            cand, cand_per_lane, ref, rule, state, out, L, C, r, d, stream)
      : launch_marginals_dtype<Rule, float>(cand, cand_per_lane, ref, rule,
                                            state, out, L, C, r, d, stream);
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
  run_sweep<kThreads, kCost>(
      step, B, eligible + (long long)l * B, tau[l], budget[l],
      kCost ? cost + (long long)l * B : nullptr, kCost ? cost_budget[l] : 0.0f,
      mask + (long long)l * B, gains + (long long)l * B);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < r) state_out[(long long)l * r + c] = step.s[j];
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

template <class Rule, typename TC>
cudaError_t launch_sweep_dtype(const void* cand, const void* ref,
                               const Rule& rule, const void* state,
                               const void* eligible, const void* tau,
                               const void* budget, const void* cost,
                               const void* cost_budget, void* mask,
                               void* state_out, void* gains, void* work,
                               int L, int B, int r, int d,
                               cudaStream_t stream) {
#define REPRO_SWEEP_CASE(P)                                                  \
  if (r <= (P) * kThreads)                                                   \
    return launch_sweep_per<Rule, TC, P>(cand, ref, rule, state, eligible,   \
                                         tau, budget, cost, cost_budget,     \
                                         mask, state_out, gains, work, L, B, \
                                         r, d, stream);
  REPRO_SWEEP_CASE(1)
  REPRO_SWEEP_CASE(2)
  REPRO_SWEEP_CASE(4)
  REPRO_SWEEP_CASE(8)
  REPRO_SWEEP_CASE(16)
#undef REPRO_SWEEP_CASE
  return cudaErrorInvalidValue;  // r > 4096: the wrappers refuse it first
}

// Launch L lane sweeps, one CTA each: cand (L, B, d) f32 or bf16, ref (r, d)
// f32, state (L, r) f32, eligible (L, B) bool, tau (L,) f32, budget (L,)
// int32; cost (L, B) f32 and cost_budget (L,) f32 select the knapsack cost
// mode, nullptr the cardinality mode; work (L, B, r) f32 scratch.
template <class Rule>
cudaError_t launch_sweep(const void* cand, int cand_is_bf16, const void* ref,
                         const Rule& rule, const void* state,
                         const void* eligible, const void* tau,
                         const void* budget, const void* cost,
                         const void* cost_budget, void* mask,
                         void* state_out, void* gains, void* work, int L,
                         int B, int r, int d, cudaStream_t stream) {
  if (L <= 0 || r <= 0) return cudaSuccess;
  return cand_is_bf16
      ? launch_sweep_dtype<Rule, __nv_bfloat16>(
            cand, ref, rule, state, eligible, tau, budget, cost, cost_budget,
            mask, state_out, gains, work, L, B, r, d, stream)
      : launch_sweep_dtype<Rule, float>(
            cand, ref, rule, state, eligible, tau, budget, cost, cost_budget,
            mask, state_out, gains, work, L, B, r, d, stream);
}

}  // namespace reftile
