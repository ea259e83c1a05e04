// The reference-set kernels of FacilityLocation and ExemplarClustering
// (facility_accept.cu and exemplar_accept.cu, and, through
// marginals_tile.cuh, facility_marginals.cu and exemplar_marginals.cu): a
// candidate block against a replicated (r, d) reference set, with the
// oracle's epilogue and residual supplied by a Rule.  The sweep's product
// is the tile of sims_tile.cuh, one CTA a tile; the marginals have their
// own Hopper tile with the same fmaf chains (marginals_tile.cuh).
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
// The sweep (the notes on what bounds it are in the .cu files) is two
// launches on the caller's stream.  product_kernel computes the (L, B, r)
// value block into an f32 workspace the wrapper allocates (a lane's block
// outgrows shared memory at r = 1024): one CTA a (lane, 64-row, 64-column)
// sims::tile, so L ceil(B / 64) ceil(r / 64) CTAs fill the card (296 at
// the path case (37, 128, 256), r = 256); Exemplar's row norms come from
// the staged cand slices in row_sq's order (SliceNorms), so they cost no
// pass over the rows.  Then one CTA a lane walks its block (walk_kernel,
// r <= 4096): thread t owns columns t, t + 256, ... of the state in
// registers, so an accept is a thread-local update; a pass
// scores a window of rows against the state at once, run_sweep's
// reduction tree batched over the window (warp_scatter.cuh), and a
// ballot finds the first row that passes.  The rows before it are
// rejected with the gains just taken, the state changes, and the next pass
// starts after it: one barrier a pass, not one a row.  A pass takes 32 rows (fewer past kPer =
// 2); after an accept among a pass's first 4 rows the walk runs the row
// loop, the next row loaded while this one is reduced, until 2 rows in a
// row are rejected.  Past r = 4096 the wide instance keeps
// run_sweep's row loop with the state in the lane's row of state_out, so
// no r is refused; it reads the same block and gives the same bits.
// Ragged rows (past C or B) and columns (past r) are masked, not padded (the
// JAX kernels pad the state with -inf or +inf).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "accept_sweep.cuh"
#include "sims_tile.cuh"
#include "warp_scatter.cuh"

namespace reftile {

using warp_scatter::Scatter;

constexpr int kThreads = 256;  // a walk's CTA, and row_sq's
constexpr int kSqParts = kThreads / sims::kTileRows;  // row_sq: 4 x 64 rows

// One step of a row norm's partial sum, each product and sum rounded on
// its own.
__device__ __forceinline__ float sq_add(float s, float v) {
  return __fadd_rn(s, __fmul_rn(v, v));
}

// sq[i] = part[4 i] + part[4 i + 1] + ... left to right, for the
// kTileRows rows (threads 0 .. kTileRows - 1).
__device__ __forceinline__ void sq_combine(const float* part, float* sq) {
  if (threadIdx.x < sims::kTileRows) {
    float t = part[threadIdx.x * kSqParts];
#pragma unroll
    for (int p = 1; p < kSqParts; ++p)
      t = __fadd_rn(t, part[threadIdx.x * kSqParts + p]);
    sq[threadIdx.x] = t;
  }
}

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
      s = sq_add(s, v);
    }
  part[threadIdx.x] = s;
  __syncthreads();
  sq_combine(part, sq);
  __syncthreads();
}

// row_sq's partial sums from the cand slices a sims::tile stages (rows past
// C are staged as 0 and add exactly 0): thread t the columns k = t % 4,
// t % 4 + 4, ... of row t / 4, in row_sq's order, so the norms have
// row_sq's bits without a pass of their own over the rows.
static_assert(sims::kThreads == kThreads, "a tile's thread t is row_sq's");
struct SliceNorms {
  float s = 0.0f;
  __device__ __forceinline__ void slice(const float (*a)[sims::kTileRows],
                                        int k0, int d) {
    const int i = threadIdx.x / kSqParts, q = threadIdx.x % kSqParts;
#pragma unroll
    for (int u = 0; u < sims::kDepth / kSqParts; ++u) {
      const int k = q + u * kSqParts;
      if (k0 + k < d) s = sq_add(s, a[k][sims::swizzle(k, i)]);
    }
  }
};

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

// The squared row norms a Rule needs (kRowNorms), in shared memory:
// finish(s) adds each row's four SliceNorms partials as row_sq adds them.
template <bool kRowNorms>
struct RowNorms {
  float sq[sims::kTileRows], part[kThreads];
  __device__ void finish(const SliceNorms& norms) {
    part[threadIdx.x] = norms.s;
    __syncthreads();
    sq_combine(part, sq);
    __syncthreads();
  }
  __device__ float at(int i) const { return sq[i]; }
};
template <>
struct RowNorms<false> {
  __device__ float at(int) const { return 0.0f; }
};

// acc[m][n] of a sims::tile at (row0, col0) as the Rule's values v(i, j),
// for the thread's kMicroRows x kMicroCols micro block (columns past r take
// column r - 1's norm; the callers never read them).
template <class Rule, typename TC>
__device__ __forceinline__ void tile_values(const Rule& rule, const TC* x,
                                            long long C, const float* ref,
                                            int r, int d, long long row0,
                                            int col0, sims::Stage& stage,
                                            RowNorms<Rule::kRowNorms>& rn,
                                            float v[sims::kMicroRows]
                                                   [sims::kMicroCols]) {
  if constexpr (Rule::kRowNorms) {
    SliceNorms norms;
    sims::tile<TC, Rule::kRectify>(x, C, ref, r, d, row0, col0, stage, v,
                                   norms);
    rn.finish(norms);
  } else {
    sims::NoHook none;
    sims::tile<TC, Rule::kRectify>(x, C, ref, r, d, row0, col0, stage, v,
                                   none);
  }
  const int mr = sims::micro_row(), mc = sims::micro_col();
#pragma unroll
  for (int n = 0; n < sims::kMicroCols; ++n) {
    const int c = min(col0 + mc + n, r - 1);
#pragma unroll
    for (int m = 0; m < sims::kMicroRows; ++m)
      v[m][n] = rule.value(v[m][n], c, rn.at(mr + m));
  }
}

// --------------------------------------------------------------- product
// One CTA a (lane, 64-row, 64-column) tile of the (L, B, r) value block:
// the sims::tile at (row0, col0) of the lane's chunk, as the Rule's values,
// written to the workspace.  The tiles are the grid (lane slowest, then
// rows, then columns), so L * ceil(B / 64) * ceil(r / 64) CTAs share the
// card, and every value is the fmaf chain over k = 0 .. d - 1 that the
// one-CTA-a-lane loop over the same tiles computed.
template <class Rule, typename TC>
__global__ void __launch_bounds__(sims::kThreads)
product_kernel(const TC* __restrict__ cand, const float* __restrict__ ref,
               Rule rule, float* __restrict__ work, int B, int r, int d) {
  __shared__ __align__(16) sims::Stage stage;
  __shared__ RowNorms<Rule::kRowNorms> rn;
  const int col_tiles = (r + sims::kTileCols - 1) / sims::kTileCols;
  const int row_tiles = (B + sims::kTileRows - 1) / sims::kTileRows;
  const long long tile = blockIdx.x;
  const int col0 = (int)(tile % col_tiles) * sims::kTileCols;
  const int row0 = (int)(tile / col_tiles % row_tiles) * sims::kTileRows;
  const long long l = tile / col_tiles / row_tiles;
  const TC* x = cand + l * B * d;
  float* block = work + l * B * r;
  float v[sims::kMicroRows][sims::kMicroCols];
  tile_values(rule, x, B, ref, r, d, row0, col0, stage, rn, v);
  const int mr = sims::micro_row(), mc = sims::micro_col();
#pragma unroll
  for (int m = 0; m < sims::kMicroRows; ++m)
#pragma unroll
    for (int n = 0; n < sims::kMicroCols; ++n) {
      const int i = row0 + mr + m, c = col0 + mc + n;
      if (i < B && c < r) block[(long long)i * r + c] = v[m][n];
    }
}

// ------------------------------------------------------------------ walk
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// An accept among a wide pass's first kCloseRows rows switches the walk
// to the row loop (Walk::rows), until kMisses rejected rows in a row
// switch it back.
constexpr int kCloseRows = 4;
constexpr int kMisses = 2;
// Rows a wide pass scores (each thread holds their kPer columns in
// registers until the pass decides).
template <int kPer>
__host__ __device__ constexpr int wide_rows() {
  return kPer <= 2 ? 32 : kPer == 4 ? 16 : 8;
}
__host__ __device__ constexpr int log2_rows(int n) {
  return n <= 1 ? 0 : 1 + log2_rows(n / 2);
}

// The walk of one lane over its (B, r) value block: the state in
// registers (thread t owns columns t, t + 256, ...), the decisions of
// run_sweep (accept_sweep.cuh) in both modes.
template <class Rule, int kPer, bool kCost>
struct Walk {
  static constexpr int kWide = wide_rows<kPer>();
  const float* block;  // this lane's (B, r) values, written by product_kernel
  const unsigned char* eligible;
  const float* cost;
  unsigned char* mask;
  float* gains;
  float (*part)[kWarps][32];  // [2][kWarps][32] warp sums, in shared memory
  int B, r, budget;
  float tau, cost_budget;
  float s[kPer];
  int n_acc = 0, par = 0;
  float spent = 0.0f;

  // Score rows [cur, cur + kRows) against the state, decide them at once,
  // write the outputs of the rows decided, and apply the accept.  Returns
  // the offset of the accepted row, or kRows when every row was rejected.
  // The state changes only on an accept, so the rows before the first that
  // passes are rejected with the gains just taken, and the rows after it
  // are scored again by the next pass.  One barrier a pass.
  template <int kRows>
  __device__ __forceinline__ int pass(int cur) {
    constexpr int kShift = 5 - log2_rows(kRows);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ra = lane >> kShift, row = cur + ra;
    const bool e = row < B && eligible[row];
    const float c = kCost && row < B ? cost[row] : 0.0f;
    float v[kRows][kPer], p[kRows];
#pragma unroll
    for (int w = 0; w < kRows; ++w) {
      const int i = cur + w;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = threadIdx.x + j * kThreads;
        v[w][j] = (i < B && col < r) ? __ldg(block + i * r + col) : 0.0f;
      }
    }
    // each thread's columns in j order, as run_sweep's Step summed them
    // (columns past r hold s = 0 and v = 0 and add exactly 0)
#pragma unroll
    for (int w = 0; w < kRows; ++w) {
      p[w] = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) p[w] += Rule::residual(s[j], v[w][j]);
    }
    // run_sweep's warp butterfly, batched over the rows (warp_scatter.cuh)
    part[par][warp][ra] = Scatter<kRows, 16>::run(p, lane);
    __syncthreads();
    // the warp sums added in warp order, as run_sweep adds them; every
    // warp forms every gain and takes the same decisions
    float gain = part[par][0][ra];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) gain += part[par][w][ra];
    par ^= 1;
    bool acc;
    if constexpr (kCost)
      acc = e && gain >= __fmul_rn(tau, c) && n_acc < budget &&
            __fadd_rn(spent, c) <= cost_budget;
    else
      acc = e && gain >= tau && n_acc < budget;
    const unsigned bal = __ballot_sync(kFull, acc);
    const int first = bal ? (__ffs(bal) - 1) >> kShift : kRows;
    if (warp == 0 && (lane & ((1 << kShift) - 1)) == 0 && row < B &&
        ra <= first) {
      mask[row] = ra == first ? 1 : 0;
      gains[row] = gain;
    }
    if (first < kRows) {
      if constexpr (kCost)
        spent = __fadd_rn(spent, __shfl_sync(kFull, c, first << kShift));
      ++n_acc;
      float vf[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) vf[j] = v[0][j];
#pragma unroll
      for (int w = 1; w < kRows; ++w)
        if (w == first)
#pragma unroll
          for (int j = 0; j < kPer; ++j) vf[j] = v[w][j];
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[j] = Rule::update(s[j], vf[j]);
    }
    return first;
  }

  // The row loop of run_sweep from row cur, its order and bits (one
  // butterfly, one barrier a row), with the next row's values, eligibility
  // and cost loaded while this one is reduced; it stops at B or after
  // kMisses rejected rows in a row.  Returns the row it stopped at.
  __device__ __forceinline__ int rows(int cur) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float nv[kPer];
    bool ne = false;
    float nc = 0.0f;
    auto fetch = [&](int i) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = threadIdx.x + j * kThreads;
        nv[j] = (i < B && col < r) ? __ldg(block + i * r + col) : 0.0f;
      }
      ne = i < B && eligible[i];
      nc = kCost && i < B ? cost[i] : 0.0f;
    };
    fetch(cur);
    for (int misses = 0; cur < B && misses < kMisses; ++cur) {
      float v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = nv[j];
      const bool e = ne;
      const float c = nc;
      fetch(cur + 1);
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) p += Rule::residual(s[j], v[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
      if (lane == 0) part[par][warp][0] = p;
      __syncthreads();
      float gain = part[par][0][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) gain += part[par][w][0];
      par ^= 1;
      bool acc;
      if constexpr (kCost) {
        acc = e && gain >= __fmul_rn(tau, c) && n_acc < budget &&
              __fadd_rn(spent, c) <= cost_budget;
        if (acc) spent = __fadd_rn(spent, c);
      } else {
        acc = e && gain >= tau && n_acc < budget;
      }
      if (acc) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[j] = Rule::update(s[j], v[j]);
        ++n_acc;
        misses = 0;
      } else {
        ++misses;
      }
      if (threadIdx.x == 0) {
        mask[cur] = acc ? 1 : 0;
        gains[cur] = gain;
      }
    }
    return cur;
  }
};

// The narrow instance (r <= kPer * kThreads): one CTA a lane walks its
// block.  A wide pass scores wide_rows<kPer>() rows; after an accept in the
// first kCloseRows rows of a pass the walk takes the row loop, until
// kMisses rows in a row are rejected.
template <class Rule, int kPer, bool kCost>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ state,
            const unsigned char* __restrict__ eligible,
            const float* __restrict__ tau, const int* __restrict__ budget,
            const float* __restrict__ cost,
            const float* __restrict__ cost_budget,
            unsigned char* __restrict__ mask, float* __restrict__ state_out,
            float* __restrict__ gains, const float* __restrict__ work, int B,
            int r) {
  using W = Walk<Rule, kPer, kCost>;
  constexpr int kWide = W::kWide;
  __shared__ float part[2][kWarps][32];
  const long long l = blockIdx.x;
  W walk;
  walk.block = work + l * B * r;
  walk.eligible = eligible + l * B;
  walk.cost = kCost ? cost + l * B : nullptr;
  walk.mask = mask + l * B;
  walk.gains = gains + l * B;
  walk.part = part;
  walk.B = B;
  walk.r = r;
  walk.budget = budget[l];
  walk.tau = tau[l];
  walk.cost_budget = kCost ? cost_budget[l] : 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    walk.s[j] = c < r ? state[l * r + c] : 0.0f;
  }
  for (int cur = 0; cur < B;) {
    const int f = walk.template pass<kWide>(cur);
    cur += f < kWide ? f + 1 : kWide;
    if (f < kCloseRows) cur = walk.rows(cur);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < r) state_out[l * r + c] = walk.s[j];
  }
}

// The wide instance's Step (r > 16 * kThreads = 4096): the state lives in
// this lane's row of state_out (global memory), each thread still owning
// columns t, t + 256, ..., so an accept needs no barrier.  It sums the same
// residuals in the same order as the narrow walk (whose columns past r add
// exactly 0) and reduces each row with run_sweep's butterfly, so it gives
// the bits the narrow instance would.
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

// The wide instance: one CTA a lane runs run_sweep's row loop.
template <class Rule, bool kCost>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const float* __restrict__ state,
            const unsigned char* __restrict__ eligible,
            const float* __restrict__ tau, const int* __restrict__ budget,
            const float* __restrict__ cost,
            const float* __restrict__ cost_budget,
            unsigned char* __restrict__ mask, float* __restrict__ state_out,
            float* __restrict__ gains, const float* __restrict__ work, int B,
            int r) {
  const long long l = blockIdx.x;
  WideStep<Rule> step{work + l * B * r, state_out + l * r, r, 0};
  for (int c = threadIdx.x; c < r; c += kThreads) step.s[c] = state[l * r + c];
  run_sweep<kThreads, kCost>(step, B, eligible + l * B, tau[l], budget[l],
                             kCost ? cost + l * B : nullptr,
                             kCost ? cost_budget[l] : 0.0f, mask + l * B,
                             gains + l * B);
}

template <class Rule, int kPer, bool kCost>
cudaError_t launch_walk(const float* st, const unsigned char* el,
                        const float* ta, const int* bu, const float* co,
                        const float* cb, unsigned char* ma, float* so,
                        float* ga, const float* wo, int L, int B, int r,
                        cudaStream_t stream) {
  if constexpr (kPer == 0)
    wide_kernel<Rule, kCost><<<L, kThreads, 0, stream>>>(
        st, el, ta, bu, co, cb, ma, so, ga, wo, B, r);
  else
    walk_kernel<Rule, kPer, kCost><<<L, kThreads, 0, stream>>>(
        st, el, ta, bu, co, cb, ma, so, ga, wo, B, r);
  return cudaGetLastError();
}

template <class Rule, int kPer>
cudaError_t launch_walk_per(const void* state, const void* eligible,
                            const void* tau, const void* budget,
                            const void* cost, const void* cost_budget,
                            void* mask, void* state_out, void* gains,
                            const float* work, int L, int B, int r,
                            cudaStream_t stream) {
  const float* st = static_cast<const float*>(state);
  const unsigned char* el = static_cast<const unsigned char*>(eligible);
  const float* ta = static_cast<const float*>(tau);
  const int* bu = static_cast<const int*>(budget);
  const float* co = static_cast<const float*>(cost);
  const float* cb = static_cast<const float*>(cost_budget);
  unsigned char* ma = static_cast<unsigned char*>(mask);
  float* so = static_cast<float*>(state_out);
  float* ga = static_cast<float*>(gains);
  return co ? launch_walk<Rule, kPer, true>(st, el, ta, bu, co, cb, ma, so,
                                            ga, work, L, B, r, stream)
            : launch_walk<Rule, kPer, false>(st, el, ta, bu, co, cb, ma, so,
                                             ga, work, L, B, r, stream);
}

// Launch L lane sweeps: the product over the whole card, then one CTA a
// lane walks its block.  cand (L, B, d) f32 or bf16, ref (r, d) f32, state
// (L, r) f32, eligible (L, B) bool, tau (L,) f32, budget (L,) int32; cost
// (L, B) f32 and cost_budget (L,) f32 select the knapsack cost mode,
// nullptr the cardinality mode; work (L, B, r) f32 scratch; per the
// instance the wrapper picked (kernels/_wrap.py, reference_sweep_per):
// columns per thread of the narrow instance (1, 2, 4, 8 or 16, with
// r <= per * kThreads), or 0 for the wide instance.
template <class Rule>
cudaError_t launch_sweep(const void* cand, int cand_is_bf16, const void* ref,
                         const Rule& rule, const void* state,
                         const void* eligible, const void* tau,
                         const void* budget, const void* cost,
                         const void* cost_budget, void* mask,
                         void* state_out, void* gains, void* work, int L,
                         int B, int r, int d, int per, cudaStream_t stream) {
  if (L <= 0 || r <= 0) return cudaSuccess;
  if (per > 0 && r > per * kThreads) return cudaErrorInvalidValue;
  float* wo = static_cast<float*>(work);
  const float* rf = static_cast<const float*>(ref);
  const long long tiles =
      (long long)L * ((B + sims::kTileRows - 1) / sims::kTileRows) *
      ((r + sims::kTileCols - 1) / sims::kTileCols);
  if (tiles > 0) {
    if (cand_is_bf16)
      product_kernel<Rule, __nv_bfloat16>
          <<<(unsigned)tiles, sims::kThreads, 0, stream>>>(
              static_cast<const __nv_bfloat16*>(cand), rf, rule, wo, B, r,
              d);
    else
      product_kernel<Rule, float>
          <<<(unsigned)tiles, sims::kThreads, 0, stream>>>(
              static_cast<const float*>(cand), rf, rule, wo, B, r, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#define REPRO_WALK_CASE(P)                                                 \
  case P:                                                                  \
    return launch_walk_per<Rule, P>(state, eligible, tau, budget, cost,    \
                                    cost_budget, mask, state_out, gains,   \
                                    wo, L, B, r, stream);
  switch (per) {
    REPRO_WALK_CASE(0)
    REPRO_WALK_CASE(1)
    REPRO_WALK_CASE(2)
    REPRO_WALK_CASE(4)
    REPRO_WALK_CASE(8)
    REPRO_WALK_CASE(16)
  }
#undef REPRO_WALK_CASE
  return cudaErrorInvalidValue;
}

}  // namespace reftile
