// The accept sweep of the four feature oracles (coverage_accept.cu,
// weighted_coverage_accept.cu, saturated_coverage_accept.cu,
// graph_cut_accept.cu) over an O(d) elementwise state, with a Rule from
// feature_rules.cuh, in the cardinality mode or the knapsack cost mode (a
// (L, B) row-cost matrix and an (L,) remaining budget; the decisions are
// run_sweep's, accept_sweep.cuh).
//
// One CTA of 128 threads sweeps one lane's (B, d) tile; thread t owns
// features t, t + 128, ..., and its share of a row's gain sums them in that
// order; a row's gain is the warp butterfly of the shares, then the four
// warp sums added in warp order.  That order is the first port's, so every
// instance below gives its bits.  Three instances, picked by the wrapper
// from the sweep, the dtype of x and d (kernels/_wrap.py,
// feature_sweep_instance):
//  * the walk (d <= kMaxPer * kThreads = 2048): every thread holds its
//    kPer features' state, pre = Rule::pre(s) and the Rule's operands in
//    registers for the whole sweep, and the walk decides several rows a
//    barrier in one of three ways, all of which give the row loop's
//    decisions and gains:
//     - a pass that hopes for rejects (Walk::pass) scores a window of rows
//       (up to wide_rows<kPer>(): 32 at kPer <= 2) against the state and
//       keeps the decisions up to the first accept;
//     - a pass that hopes for accepts (Walk::hope) scores each row against
//       the state the rows before it would leave if every row that fits
//       were accepted, and keeps the decisions up to the first row that
//       fits but fails;
//     - the row loop (Walk::row_loop) decides kTree rows a barrier, each
//       scored against every state the rows before it can leave
//       (Walk::tree: 2^kTree - 1 shares).
//    A pass's rows are reduced by one reduce-scatter a warp
//    (warp_scatter.cuh), one barrier, and every warp adds the warp sums of
//    every row and takes the same decisions; each row's eligibility and
//    operand (its cost) is loaded once, ahead of the barrier, by the lanes
//    that decide it.  The walk switches between them on what the last
//    decisions were (kCloseRows, kMisses, kHits), and widens a pass that
//    met its hope.  Coverage takes its square roots behind one range test
//    (rules::sqrt_rn, sqrtf's bits);
//  * the row loop (the same widths; the first port's narrow instance):
//    the state in registers as in the walk, run_sweep's loop of one row a
//    barrier (accept_sweep.cuh), row i + 1 loaded while row i is reduced.
//    The wrapper keeps it where the walk measured slower on an H100
//    (_wrap.FEATURE_SWEEP_LOOPS: graph cut at d <= 256, whose lanes accept
//    about every other row, and its f32 sweep at 8 features a thread, and
//    weighted coverage's f32 sweep at 16);
//  * wide (any d): run_sweep's row loop with the state in the lane's row
//    of state_out (global memory; 37 lanes x 4096 features x 4 B = 0.6 MB
//    stay resident in L2); each row reads its features' state and operands
//    and recomputes pre from s, so no width is refused short of device
//    memory.  A thread reads and writes only its own features, so the
//    state needs no barrier.
// All three sum the same terms in the same order, and pre is a function of
// s alone, so every instance gives the bits of every other.
// Outputs: mask (L, B) bool, post-sweep state (L, d) f32, and each row's
// gain at scan time (L, B) f32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "accept_sweep.cuh"
#include "feature_rules.cuh"
#include "warp_scatter.cuh"

namespace feature_sweep {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPer = 16;  // features per thread: d <= 2048
constexpr unsigned kFull = 0xffffffffu;
// The walk's passes hope for rejects (Walk::pass) or for accepts
// (Walk::hope).  An accept among a pass's first kCloseRows rows (a surprise,
// when hopeful) switches it to the row loop (Walk::row_loop), until kMisses
// rejected rows in a row (kMissesDense once the loop has accepted a row)
// switch it back to passes that hope for rejects, or kHits accepted rows in
// a row to passes that hope for accepts.  A row loop that accepted a row is
// followed by a pass of kNarrowRows rows; each pass that meets its hope
// doubles the next one's rows, up to wide_rows.
constexpr int kCloseRows = 8;
constexpr int kMisses = 2;
constexpr int kMissesDense = 16;
constexpr int kHits = 6;
constexpr int kNarrowRows = 8;

using warp_scatter::Scatter;

// Rows a pass scores: each thread holds their kPer features in registers
// until the pass decides.
template <int kPer>
__host__ __device__ constexpr int wide_rows() {
  return kPer <= 2 ? 32 : kPer == 4 ? 16 : 8;
}
// Rows the row loop decides a barrier (Walk::tree): each thread holds
// 2^kTree - 1 states of its kPer features.
template <int kPer>
__host__ __device__ constexpr int tree_rows() {
  return kPer <= 8 ? 2 : 1;
}
__host__ __device__ constexpr int log2_rows(int n) {
  return n <= 1 ? 0 : 1 + log2_rows(n / 2);
}

// the row loop's and the wide instance's loads
__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// the walk's: bf16 too through the read-only path (see Walk::load)
__device__ __forceinline__ float load_nc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_nc(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The decision's per-lane operands as the launch got them: tau (L,) and
// budget (L,), and for the cost mode cost (L, B) and cost_budget (L,).
struct Operands {
  const float* tau;
  const int* budget;
  const float* cost;
  const float* cost_budget;
};

// A mode: what a row must meet besides its eligibility, and the lane's
// running state under it (the same in every thread of the CTA).
//   Mode(ops, l, B)        lane l at the start of its sweep
//   Row row(i)             row i's operand (its cost)
//   bool passes(gain, r)   the row's gain meets the threshold
//   bool fits(r)           the row fits what the lane has taken so far
//   void take(r)           the state after accepting the row
//   static Row from(r, k)  the operand lane k of the warp holds
// A row is accepted iff it is eligible, passes and fits; each comparison
// and update is run_sweep's, rounded as it rounds.
struct Cardinality {
  struct Row {};
  float tau;
  int budget, n_acc = 0;
  __device__ Cardinality(const Operands& o, long long l, int)
      : tau(o.tau[l]), budget(o.budget[l]) {}
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ bool passes(float gain, Row) const {
    return gain >= tau;
  }
  __device__ __forceinline__ bool fits(Row) const { return n_acc < budget; }
  __device__ __forceinline__ void take(Row) { ++n_acc; }
  static __device__ __forceinline__ Row from(Row r, int) { return r; }
};

struct Knapsack {
  struct Row {
    float c;
  };
  const float* cost;  // this lane's (B,) row costs
  float tau, cost_budget, spent = 0.0f;
  int budget, n_acc = 0;
  __device__ Knapsack(const Operands& o, long long l, int B)
      : cost(o.cost + l * B), tau(o.tau[l]), cost_budget(o.cost_budget[l]),
        budget(o.budget[l]) {}
  __device__ __forceinline__ Row row(int i) const { return {cost[i]}; }
  __device__ __forceinline__ bool passes(float gain, Row r) const {
    return gain >= __fmul_rn(tau, r.c);
  }
  __device__ __forceinline__ bool fits(Row r) const {
    return n_acc < budget && __fadd_rn(spent, r.c) <= cost_budget;
  }
  __device__ __forceinline__ void take(Row r) {
    spent = __fadd_rn(spent, r.c);
    ++n_acc;
  }
  static __device__ __forceinline__ Row from(Row r, int k) {
    return {__shfl_sync(kFull, r.c, k)};
  }
};

// The narrow instance's walk of one lane: the state in registers, the
// decisions of run_sweep in the Mode.
template <typename T, int kPer, class Rule, class Mode>
struct Walk {
  static constexpr int kWide = wide_rows<kPer>();
  static constexpr int kTree = tree_rows<kPer>();
  using Row = typename Mode::Row;
  const T* x;  // this lane's (B, d) tile
  const unsigned char* eligible;
  unsigned char* mask;
  float* gains;
  float (*part)[kWarps][32];  // [2][kWarps][32] warp sums, in shared memory
  int B, d;
  Mode mode;
  float s[kPer], pre[kPer], ops[kPer][Rule::kFeat + 1];
  int off[kPer];  // this thread's features, clamped to d - 1 (bf16 reads)
  int par = 0;

  __device__ Walk(const T* x_, const float* state, const Rule& rule,
                  const unsigned char* eligible_, unsigned char* mask_,
                  float* gains_, float (*part_)[kWarps][32], int B_, int d_,
                  const Mode& mode_)
      : x(x_), eligible(eligible_), mask(mask_), gains(gains_), part(part_),
        B(B_), d(d_), mode(mode_) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = threadIdx.x + j * kThreads;
#pragma unroll
      for (int k = 0; k < Rule::kFeat; ++k)
        ops[j][k] = f < d ? rule.operand(k, f) : 0.0f;
      s[j] = f < d ? state[f] : 0.0f;
      pre[j] = Rule::pre(s[j], ops[j]);
      if constexpr (!std::is_same<T, float>::value) off[j] = min(f, d - 1);
    }
  }

  __device__ __forceinline__ bool owns(int j) const {
    return threadIdx.x + j * kThreads < d;
  }

  // this thread's first feature of row i; rows past B read row B - 1,
  // whose values no decision of theirs reads
  __device__ __forceinline__ const T* row_ptr(int i) const {
    return x + (long long)min(i, B - 1) * d + threadIdx.x;
  }
  // x of this thread's features of a row (0 past d).  A bf16 read is
  // inline assembly, which the compiler branches around rather than
  // predicates, so each bf16 read takes a feature that exists (d - 1 past
  // d) and the value is dropped after it; f32 reads are predicated (on an
  // H100 the bf16 way costs the f32 graph-cut sweep ~20 %, the f32 way
  // the bf16 sweeps 10-25 %).
  __device__ __forceinline__ void load(const T* xr, float* v) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        v[j] = owns(j) ? load_nc(xr + j * kThreads) : 0.0f;
      } else {
        const float a = load_nc(xr - threadIdx.x + off[j]);
        v[j] = owns(j) ? a : 0.0f;
      }
    }
  }

  // p[w] = this thread's share of row w's gain against the state s (its
  // pre): the terms of its features in j order, as the first port's row
  // loop summed them (features past d are not summed).  v[w] holds row w's
  // x; the roots of Coverage overwrite it, root_w = sqrtf(s + x_w).
  template <int kRows>
  __device__ __forceinline__ void shares(const float* s, const float* pre,
                                         float (*v)[kPer], float* p) const {
    if constexpr (rules::takes_roots<Rule>::value) {
      // the roots of every row behind one range test (features past d
      // take the root of 1, which no sum reads)
#pragma unroll
      for (int w = 0; w < kRows; ++w)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          v[w][j] = owns(j) ? s[j] + v[w][j] : 1.0f;
      rules::sqrt_rn<kRows * kPer>(&v[0][0]);
#pragma unroll
      for (int w = 0; w < kRows; ++w) {
        p[w] = 0.0f;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (owns(j)) p[w] += Rule::root_term(v[w][j], pre[j], ops[j]);
      }
    } else {
#pragma unroll
      for (int w = 0; w < kRows; ++w) {
        p[w] = 0.0f;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (owns(j)) p[w] += Rule::term(s[j], pre[j], v[w][j], ops[j]);
      }
    }
  }

  // pre from the state (Coverage's roots behind one range test)
  __device__ __forceinline__ void renew_pre() {
    if constexpr (rules::takes_roots<Rule>::value) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) pre[j] = s[j];
      rules::sqrt_rn<kPer>(pre);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) pre[j] = Rule::pre(s[j], ops[j]);
    }
  }

  // the state after accepting a row with x v
  __device__ __forceinline__ void accept(const float* v) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = Rule::update(s[j], v[j]);
    renew_pre();
  }

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
    // lane a decides row cur + (a >> kShift): its eligibility and operand
    // are loaded now, ahead of the reduction
    const int ra = lane >> kShift, row = cur + ra;
    const bool e = row < B && eligible[row];
    const Row op = row < B ? mode.row(row) : Row{};
    float v[kRows][kPer], p[kRows];
#pragma unroll
    for (int w = 0; w < kRows; ++w) load(row_ptr(cur + w), v[w]);
    shares<kRows>(s, pre, v, p);
    // run_sweep's warp butterfly, batched over the rows
    part[par][warp][ra] = Scatter<kRows, 16>::run(p, lane);
    __syncthreads();
    // the warp sums added in warp order, as run_sweep adds them; every
    // warp forms every gain and takes the same decisions
    float gain = part[par][0][ra];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) gain += part[par][w][ra];
    par ^= 1;
    const bool acc = e && mode.passes(gain, op) && mode.fits(op);
    const unsigned bal = __ballot_sync(kFull, acc);
    const int first = bal ? (__ffs(bal) - 1) >> kShift : kRows;
    if (warp == 0 && (lane & ((1 << kShift) - 1)) == 0 && row < B &&
        ra <= first) {
      mask[row] = ra == first ? 1 : 0;
      gains[row] = gain;
    }
    if (first < kRows) {
      mode.take(Mode::from(op, first << kShift));
      float vf[kPer];
      load(row_ptr(cur + first), vf);
      accept(vf);
    }
    return first;
  }

  // A hopeful pass: score rows [cur, cur + kRows) against the states they
  // would meet if every row that fits were accepted (every thread runs the
  // mode and its features' state through the rows), decide them at once,
  // and keep the decisions up to the first row that fits but does not
  // pass (a surprise: rejected, and the rows after it met another state).
  // The rows before it got the gains the row loop would have given them.
  // Returns the offset of the surprise, or kRows when there was none.  One
  // barrier a pass.
  template <int kRows>
  __device__ __forceinline__ int hope(int cur) {
    constexpr int kShift = 5 - log2_rows(kRows);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ra = lane >> kShift, row = cur + ra;
    const Row mine = row < B ? mode.row(row) : Row{};
    // the rows that would be accepted if every gain passed (bit w: row
    // cur + w), from their eligibility and operands, which lane w << kShift
    // loaded
    const unsigned elig =
        __ballot_sync(kFull, row < B && eligible[row]);
    Row op[kRows];
    unsigned fit = 0;
    Mode hoped = mode;
#pragma unroll
    for (int w = 0; w < kRows; ++w) op[w] = Mode::from(mine, w << kShift);
#pragma unroll
    for (int w = 0; w < kRows; ++w)
      if ((elig >> (w << kShift) & 1) && hoped.fits(op[w])) {
        fit |= 1u << w;
        hoped.take(op[w]);
      }
    float v[kRows][kPer], p[kRows], hs[kPer], hp[kPer];
#pragma unroll
    for (int w = 0; w < kRows; ++w) load(row_ptr(cur + w), v[w]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      hs[j] = s[j];
      hp[j] = pre[j];
    }
    // each row's share against the state after the rows before it that
    // would be accepted
#pragma unroll
    for (int w = 0; w < kRows; ++w) {
      float r[1][kPer], q[1];
#pragma unroll
      for (int j = 0; j < kPer; ++j) r[0][j] = v[w][j];
      shares<1>(hs, hp, r, q);
      p[w] = q[0];
      if (fit >> w & 1)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          hs[j] = Rule::update(hs[j], v[w][j]);
          hp[j] = rules::takes_roots<Rule>::value
                      ? r[0][j] : Rule::pre(hs[j], ops[j]);
        }
    }
    part[par][warp][ra] = Scatter<kRows, 16>::run(p, lane);
    __syncthreads();
    float gain = part[par][0][ra];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) gain += part[par][w][ra];
    par ^= 1;
    const bool hoped_in = fit >> ra & 1;
    const unsigned bal =
        __ballot_sync(kFull, hoped_in && !mode.passes(gain, mine));
    const int surprise = bal ? (__ffs(bal) - 1) >> kShift : kRows;
    if (warp == 0 && (lane & ((1 << kShift) - 1)) == 0 && row < B &&
        ra <= surprise) {
      mask[row] = hoped_in && ra < surprise ? 1 : 0;
      gains[row] = gain;
    }
    // the state after the rows before the surprise, in their order
    const unsigned kept =
        surprise < 32 ? fit & ((1u << surprise) - 1u) : fit;
#pragma unroll
    for (int w = 0; w < kRows; ++w)
      if (kept >> w & 1) {
        mode.take(op[w]);
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[j] = Rule::update(s[j], v[w][j]);
      }
    if (kept) renew_pre();
    return surprise;
  }

  // A pass of `width` rows (kRows, 2 kRows, ... up to kWide) from row cur:
  // hopeful or not.
  template <bool kHope, int kRows>
  __device__ __forceinline__ int pass_of(int width, int cur) {
    if constexpr (kRows >= kWide)
      return kHope ? hope<kWide>(cur) : pass<kWide>(cur);
    else if (width == kRows)
      return kHope ? hope<kRows>(cur) : pass<kRows>(cur);
    else
      return pass_of<kHope, 2 * kRows>(width, cur);
  }

  // Rows cur .. cur + K - 1 at one barrier, with the row loop's decisions
  // and bits: every thread scores row r against each of the 2^r states the
  // rows before it can leave (node 2^r - 1 + q, q the decisions of rows
  // 0 .. r - 1, bit t set when row t is accepted), the 2^K - 1 warp sums
  // come from one reduce-scatter, and the decisions are taken in order,
  // each row with the gain of the node the decisions before it chose.
  // xv[r], e[r], op[r]: row cur + r's x, eligibility and operand.  Returns
  // the accepted rows (bit r: row cur + r).
  template <int K>
  __device__ __forceinline__ unsigned tree(int cur, const float (*xv)[kPer],
                                           const bool* e, const Row* op) {
    constexpr int kNodes = (1 << K) - 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float ns[kNodes][kPer], np[kNodes][kPer], p[1 << K];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      ns[0][j] = s[j];
      np[0][j] = pre[j];
    }
#pragma unroll
    for (int r = 0; r < K; ++r)
#pragma unroll
      for (int q = 0; q < (1 << r); ++q) {
        const int n = (1 << r) - 1 + q;
        float v[1][kPer], o[1];
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[0][j] = xv[r][j];
        shares<1>(ns[n], np[n], v, o);
        p[n] = o[0];
        if (r + 1 < K) {
          // the node of row r + 1 after rejecting row r, and after
          // accepting it
          const int no = (1 << (r + 1)) - 1 + q, yes = no + (1 << r);
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            ns[no][j] = ns[n][j];
            np[no][j] = np[n][j];
            ns[yes][j] = Rule::update(ns[n][j], xv[r][j]);
            np[yes][j] = rules::takes_roots<Rule>::value
                             ? v[0][j] : Rule::pre(ns[yes][j], ops[j]);
          }
        }
      }
    p[kNodes] = 0.0f;
    part[par][warp][lane >> (5 - K)] = Scatter<1 << K, 16>::run(p, lane);
    __syncthreads();
    float g[kNodes];
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      g[n] = part[par][0][n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) g[n] += part[par][w][n];
    }
    par ^= 1;
    unsigned q = 0;
    float gain[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      gain[r] = g[(1 << r) - 1];
#pragma unroll
      for (int m = 1; m < (1 << r); ++m)
        if (m == q) gain[r] = g[(1 << r) - 1 + m];
      if (e[r] && mode.passes(gain[r], op[r]) && mode.fits(op[r])) {
        mode.take(op[r]);
        q |= 1u << r;
      }
    }
    if (threadIdx.x == 0)
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (cur + r < B) {
          mask[cur + r] = q >> r & 1;
          gains[cur + r] = gain[r];
        }
    // the state after the K rows: the node of the last row, and its update
    // when it was accepted
    constexpr int kLast = (1 << (K - 1)) - 1;
    const unsigned qs = q & ((1u << (K - 1)) - 1u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s[j] = ns[kLast][j];
      pre[j] = np[kLast][j];
    }
#pragma unroll
    for (int m = 1; m < (1 << (K - 1)); ++m)
      if (m == qs)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[j] = ns[kLast + m][j];
          pre[j] = np[kLast + m][j];
        }
    if (q >> (K - 1) & 1) accept(xv[K - 1]);
    return q;
  }

  // The row loop from row cur (< B), kTree rows a barrier (tree), until B,
  // until kMisses rejected rows in a row (kMissesDense once it has accepted
  // a row), or until kHits accepted rows in a row, with the next kTree rows'
  // x, eligibility and operands loaded while these are reduced, into the
  // other of two sets of registers.  Returns the row it stopped at; `took`
  // says whether it accepted a row, `hits` whether it stopped on accepted
  // rows.
  __device__ __forceinline__ int row_loop(int cur, bool& took, bool& hits) {
    constexpr int K = kTree;
    float xv[2][K][kPer];
    bool e[2][K];
    Row op[2][K];
    const T* next = x + (long long)cur * d + threadIdx.x;
    auto fetch = [&](int i, int k) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const bool in = i + r < B;
        if constexpr (std::is_same<T, float>::value) {
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            xv[k][r][j] =
                in && owns(j) ? load_nc(next + j * kThreads) : 0.0f;
        } else {
          // rows past B read row 0 (none of their values is used)
          load(in ? next : x + threadIdx.x, xv[k][r]);
        }
        next += d;
        e[k][r] = in && eligible[i + r];
        op[k][r] = in ? mode.row(i + r) : Row{};
      }
    };
    int misses = 0, run = 0;
    // rows cur .. cur + K - 1 from set k; true when the loop stops after
    // them
    auto step = [&](int k) {
      fetch(cur + K, k ^ 1);
      const unsigned acc = tree<K>(cur, xv[k], e[k], op[k]);
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (cur + r < B) {
          if (acc >> r & 1) {
            misses = 0;
            ++run;
            took = true;
          } else {
            ++misses;
            run = 0;
          }
        }
      cur = min(cur + K, B);
      hits = run >= kHits;
      return cur >= B || hits || misses >= (took ? kMissesDense : kMisses);
    };
    took = hits = false;
    fetch(cur, 0);
    while (!step(0) && !step(1)) {
    }
    return cur;
  }
};

// The walk's instance (d <= kPer * kThreads): one CTA a lane walks its
// tile in passes and row loops (see kCloseRows).
template <typename T, int kPer, class Rule, class Mode>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const T* __restrict__ x, const float* __restrict__ state,
            Rule rule, const unsigned char* __restrict__ eligible,
            Operands lane_ops, unsigned char* __restrict__ mask,
            float* __restrict__ state_out, float* __restrict__ gains, int B,
            int d) {
  using W = Walk<T, kPer, Rule, Mode>;
  constexpr int kWide = W::kWide;
  __shared__ float part[2][kWarps][32];
  const long long l = blockIdx.x;
  W walk(x + l * B * d, state + l * d, rule, eligible + l * B, mask + l * B,
         gains + l * B, part, B, d, Mode(lane_ops, l, B));
  // hopeful passes or not, and the rows of the next pass
  bool hopeful = false;
  for (int cur = 0, width = kWide; cur < B;) {
    // the offset of the pass's accept (its surprise when hopeful), or width
    const int f = hopeful ? walk.template pass_of<true, kNarrowRows>(width, cur)
                          : walk.template pass_of<false, kNarrowRows>(width,
                                                                      cur);
    cur += f < width ? f + 1 : width;
    if (f == width) {
      width = width < kWide ? 2 * width : kWide;
    } else if (f < kCloseRows && cur < B) {
      bool took, hits;
      cur = walk.row_loop(cur, took, hits);
      hopeful = hits;
      width = hits || took ? kNarrowRows : kWide;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (walk.owns(j)) state_out[l * d + threadIdx.x + j * kThreads] = walk.s[j];
}

// The row loop's Step (run_sweep, one row a barrier): the state in
// registers as in the walk, row i + 1 loaded while row i is reduced.
template <typename T, int kPer, class Rule>
struct Step {
  const T* x;  // this lane's (B, d) tile
  int B, d;
  float s[kPer], pre[kPer], ops[kPer][Rule::kFeat + 1], cur[kPer], next[kPer];

  __device__ void load_row(int i, float* dst) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = threadIdx.x + j * kThreads;
      dst[j] = (i < B && f < d) ? load_f(x + (long long)i * d + f) : 0.0f;
    }
  }

  __device__ float partial(int i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) cur[j] = next[j];
    load_row(i + 1, next);
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = threadIdx.x + j * kThreads;
      if (f < d) p += Rule::term(s[j], pre[j], cur[j], ops[j]);
    }
    return p;
  }

  __device__ void accept() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s[j] = Rule::update(s[j], cur[j]);
      pre[j] = Rule::pre(s[j], ops[j]);
    }
  }
};

// The row loop's instance (d <= kPer * kThreads): one CTA a lane.
template <typename T, int kPer, bool kCost, class Rule>
__global__ void __launch_bounds__(kThreads)
loop_kernel(const T* __restrict__ x, const float* __restrict__ state,
            Rule rule, const unsigned char* __restrict__ eligible,
            const float* __restrict__ tau, const int* __restrict__ budget,
            const float* __restrict__ cost,
            const float* __restrict__ cost_budget,
            unsigned char* __restrict__ mask, float* __restrict__ state_out,
            float* __restrict__ gains, int B, int d) {
  const int l = blockIdx.x;
  Step<T, kPer, Rule> step;
  step.x = x + (long long)l * B * d;
  step.B = B;
  step.d = d;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = threadIdx.x + j * kThreads;
#pragma unroll
    for (int k = 0; k < Rule::kFeat; ++k)
      step.ops[j][k] = f < d ? rule.operand(k, f) : 0.0f;
    step.s[j] = f < d ? state[(long long)l * d + f] : 0.0f;
    step.pre[j] = Rule::pre(step.s[j], step.ops[j]);
  }
  step.load_row(0, step.next);
  run_sweep<kThreads, kCost>(
      step, B, eligible + (long long)l * B, tau[l], budget[l],
      kCost ? cost + (long long)l * B : nullptr, kCost ? cost_budget[l] : 0.0f,
      mask + (long long)l * B, gains + (long long)l * B);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = threadIdx.x + j * kThreads;
    if (f < d) state_out[(long long)l * d + f] = step.s[j];
  }
}

// The wide instance's Step: the state is this lane's row of state_out.
template <typename T, class Rule>
struct WideStep {
  const T* x;  // this lane's (B, d) tile
  float* s;    // this lane's (d,) state, in global memory
  Rule rule;
  int d, i;    // i: the row last scored

  __device__ float partial(int row) {
    i = row;
    const T* xr = x + (long long)row * d;
    float p = 0.0f;
    for (int f = threadIdx.x; f < d; f += kThreads) {
      float ops[Rule::kFeat + 1];
#pragma unroll
      for (int k = 0; k < Rule::kFeat; ++k) ops[k] = rule.operand(k, f);
      const float sf = s[f];
      p += Rule::term(sf, Rule::pre(sf, ops), load_f(xr + f), ops);
    }
    return p;
  }

  __device__ void accept() {
    const T* xr = x + (long long)i * d;
    for (int f = threadIdx.x; f < d; f += kThreads)
      s[f] = Rule::update(s[f], load_f(xr + f));
  }
};

template <typename T, bool kCost, class Rule>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const T* __restrict__ x, const float* __restrict__ state,
            Rule rule, const unsigned char* __restrict__ eligible,
            const float* __restrict__ tau, const int* __restrict__ budget,
            const float* __restrict__ cost,
            const float* __restrict__ cost_budget,
            unsigned char* __restrict__ mask, float* __restrict__ state_out,
            float* __restrict__ gains, int B, int d) {
  const int l = blockIdx.x;
  WideStep<T, Rule> step{x + (long long)l * B * d,
                         state_out + (long long)l * d, rule, d, 0};
  for (int f = threadIdx.x; f < d; f += kThreads)
    step.s[f] = state[(long long)l * d + f];
  run_sweep<kThreads, kCost>(
      step, B, eligible + (long long)l * B, tau[l], budget[l],
      kCost ? cost + (long long)l * B : nullptr, kCost ? cost_budget[l] : 0.0f,
      mask + (long long)l * B, gains + (long long)l * B);
}

template <typename T, int kPer, class Rule>
cudaError_t launch_per(const void* x, const void* state, const Rule& rule,
                       const void* eligible, const void* tau,
                       const void* budget, const void* cost,
                       const void* cost_budget, void* mask, void* state_out,
                       void* gains, int L, int B, int d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(state);
  const unsigned char* el = static_cast<const unsigned char*>(eligible);
  const float* ta = static_cast<const float*>(tau);
  const int* bu = static_cast<const int*>(budget);
  const float* co = static_cast<const float*>(cost);
  const float* cb = static_cast<const float*>(cost_budget);
  unsigned char* ma = static_cast<unsigned char*>(mask);
  float* so = static_cast<float*>(state_out);
  float* ga = static_cast<float*>(gains);
  if constexpr (kPer == 0) {
    if (co)
      wide_kernel<T, true, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
    else
      wide_kernel<T, false, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
  } else if constexpr (kPer < 0) {
    if (co)
      loop_kernel<T, -kPer, true, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
    else
      loop_kernel<T, -kPer, false, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
  } else {
    const Operands ops{ta, bu, co, cb};
    if (co)
      walk_kernel<T, kPer, Rule, Knapsack><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ops, ma, so, ga, B, d);
    else
      walk_kernel<T, kPer, Rule, Cardinality><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ops, ma, so, ga, B, d);
  }
  return cudaGetLastError();
}

// per: the instance the wrapper picked (feature_sweep_instance): features
// per thread of the walk (1, 2, 4, 8 or 16, with d <= per * kThreads), the
// same negated for the row loop, or 0 for the wide instance.
template <typename T, class Rule>
cudaError_t launch(const void* x, const void* state, const Rule& rule,
                   const void* eligible, const void* tau, const void* budget,
                   const void* cost, const void* cost_budget, void* mask,
                   void* state_out, void* gains, int L, int B, int d, int per,
                   cudaStream_t stream) {
  if (per != 0 && d > (per < 0 ? -per : per) * kThreads)
    return cudaErrorInvalidValue;
#define REPRO_SWEEP_CASE(P)                                                   \
  case P:                                                                     \
    return launch_per<T, P, Rule>(x, state, rule, eligible, tau, budget,      \
                                  cost, cost_budget, mask, state_out, gains,  \
                                  L, B, d, stream);
  switch (per) {
    REPRO_SWEEP_CASE(0)
    REPRO_SWEEP_CASE(1)
    REPRO_SWEEP_CASE(2)
    REPRO_SWEEP_CASE(4)
    REPRO_SWEEP_CASE(8)
    REPRO_SWEEP_CASE(kMaxPer)
    REPRO_SWEEP_CASE(-1)
    REPRO_SWEEP_CASE(-2)
    REPRO_SWEEP_CASE(-4)
    REPRO_SWEEP_CASE(-8)
    REPRO_SWEEP_CASE(-kMaxPer)
  }
#undef REPRO_SWEEP_CASE
  return cudaErrorInvalidValue;
}

// Launch L lane sweeps, one CTA each, dispatching on the dtype of x
// (float32 or bfloat16), on the instance (per, see launch) and on the
// mode: cost (L, B) f32 and cost_budget (L,) f32 select the cost mode,
// nullptr the cardinality mode.  Nothing runs when L or d is 0.
template <class Rule>
cudaError_t launch_any(const void* x, int x_is_bf16, const void* state,
                       const Rule& rule, const void* eligible,
                       const void* tau, const void* budget, const void* cost,
                       const void* cost_budget, void* mask, void* state_out,
                       void* gains, int L, int B, int d, int per,
                       cudaStream_t stream) {
  if (L <= 0 || d <= 0) return cudaSuccess;
  return x_is_bf16
      ? launch<__nv_bfloat16>(x, state, rule, eligible, tau, budget, cost,
                              cost_budget, mask, state_out, gains, L, B, d,
                              per, stream)
      : launch<float>(x, state, rule, eligible, tau, budget, cost,
                      cost_budget, mask, state_out, gains, L, B, d, per,
                      stream);
}

}  // namespace feature_sweep
