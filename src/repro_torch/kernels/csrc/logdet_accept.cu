// Fused LogDetDiversity / MutualInformationGaussian chunk-accept sweep on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logdet_accept.py,
// logdet_accept (body _la_kernel), in both of its modes: cardinality
// (cost=None) and knapsack cost (a (B,) row-cost vector and a remaining
// budget, the rule of accept_sweep.cuh).  One launch serves L lanes, one
// CTA each, in place of the JAX engines' vmap over the tau grid.
//
// Per lane, rows are taken in stream order against the whitened basis U
// (k, d); for row i
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
// live rows' products fewer operations still; the real cost is the chain
// of B dependent steps.  The first port ran every step in full (k + 1
// warp dot products, a serial sum of the v_j^2, two barriers per row), so
// 0.50 ms went to 128 steps of ~7,800 cycles on 37 SMs.  Almost all of that
// work does not depend on the decisions: the projections onto the basis
// rows present at launch, the norms and the first terms of each row's
// sum of squares can be formed for every row at once.
//
// The narrow instance (U in shared memory) runs a block of up to 128 rows
// (rows_per_block; the whole chunk on the main path) in three phases:
//   1. In parallel: stage U and the block's rows in shared memory, then
//      form ||x_i||^2 and every <U_j, x_i> with j below the live count at
//      the block's start into a (rows, k) dot matrix, and each row's
//      partial sum of squares vv_i = sum_j (alpha <U_j, x_i>)^2 in j order.
//   2. The walk, over a window of 32 rows: the window's undecided rows
//      score their gains from sq_i and vv_i at once (one thread a row)
//      and test the accept rule against the lane's running count and
//      spend; a ballot finds the first row that accepts.  The rows before
//      it are rejected with the gains just scored, so a rejected row costs
//      no reduction.  When the walk leaves the window, the next 32 rows
//      catch up with the rows appended since the block's start in one
//      tiled product (each vv extended in j order).  Once the lane's size
//      reaches k every later append is dropped and the gains stop moving:
//      one pass scores the rest, and every thread runs the rule down them.
//   3. Only on accept: the append (one thread per feature, each feature's
//      chain in j order over the accepted row's coefficients, staged
//      once), then the new basis row's dot with each later row of the
//      window (one row an 8-thread group), added to that row's vv, and
//      the row scored again, so the next decision needs no pass.
// Every sum keeps the first port's order, so the bits are its bits: a dot
// <a, b> there was one warp's lane-strided fmaf chains (lane l takes
// features l, l + 32, ...) folded by an xor butterfly (l + (l ^ 16), then
// ^ 8, ^ 4, ^ 2, ^ 1); here eight threads of a group hold the chains of
// lanes 4 m .. 4 m + 3 (16-byte fragments of features 32 t + 4 m ..), fold
// them across the group with the same pairs (^ 16 -> m ^ 4, ^ 8 -> m ^ 2,
// ^ 4 -> m ^ 1, each add split so that every thread keeps a share of the
// dots), then in the thread (^ 2, ^ 1).  The sum of squares runs in j
// order from 0 as before, ||x||^2 is the same mul-then-add chains.  No
// atomics, so a repeated launch gives the same bits.
//
// The wide instance (wide_kernel, picked by the wrapper when U, the
// block's rows and its dot matrix outgrow the 227 KiB a block may use:
// k = 64 at d = 1024, or k = d = 256) keeps the first port's loop: U lives in the
// lane's (k, d) slice of U_out, copied there from U_in first and appended
// in place (37 x 64 x 1024 x 4 B = 9.7 MB, resident in the 50 MB L2), rows
// are read from x where they lie, and only the k + 1 dot products of the
// row being scored stay in shared memory.  It computes the same sums in
// the same order, so it gives the bits the narrow one would.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the narrow instance's row blocks: at most kMaxRows rows (one thread
// each in the walk), at least kMinRows, a multiple of kMinRows
constexpr int kMaxRows = 128;
constexpr int kMinRows = 8;
constexpr int kGroup = 8;                   // threads of a dot group
constexpr int kGroups = kThreads / kGroup;  // 32
constexpr int kNone = 1 << 30;              // no row accepts
constexpr int kWindow = 32;                 // rows the walk keeps current

struct Params {
  float alpha, scale, eps;
};

// The narrow instance's shared memory, in floats: U [k][dp], the block's
// rows [rows][dp] (dp = d rounded up to 32, zero past d), an append's
// coefficients alpha <U_j, x> [k rounded up to 4], the dot matrix
// [rows][kp] (kp = k | 1: an odd pitch, so a thread per row reads it
// without bank conflicts), ||x||^2, vv, the gain and the cost per row, two
// sets of eight warp ballots and four words of eligibility bits.  The same
// sum as kernels/logdet_accept.py.
struct Layout {
  int dp, kp, rows;
  __host__ __device__ static int pad(int d) { return (d + 31) / 32 * 32; }
  __host__ __device__ static long long fixed(int k, int d) {
    return (long long)k * pad(d) + (k + 3) / 4 * 4 + 20;
  }
  __host__ __device__ static long long floats(int k, int d, int rows) {
    return fixed(k, d) + (long long)rows * (pad(d) + (k | 1) + 4);
  }
};

// Rows a block of the narrow instance holds: the most (a multiple of 8,
// at most 128) that fit in `limit` bytes with U, or 0 (the wide instance).
inline int rows_per_block(int k, int d, long long limit) {
  const long long per_row = Layout::pad(d) + (k | 1) + 4;
  long long rows = (limit / 4 - Layout::fixed(k, d)) / per_row;
  if (rows < 0) rows = 0;
  rows = rows / kMinRows * kMinRows;
  return (int)(rows < kMaxRows ? rows : kMaxRows);
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Rows [0, n) of a row-major (n, d) matrix into shared rows of pitch dp,
// widened to f32; the pads past d are left as they are (zero).  vec: d is a
// multiple of 4 and src 16-byte (f32) or 8-byte (bf16) aligned.  The
// caller waits (cp_commit_wait_all) and synchronizes.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n, int d, int dp, bool vec) {
  if (vec) {
    const int q = d / 4;
    for (int e = threadIdx.x; e < n * q; e += kThreads) {
      const int r = e / q, c = e - r * q;
      cp_async16(dst + r * dp + 4 * c, src + (long long)r * d + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < n * d; e += kThreads) {
      const int r = e / d, f = e - r * d;
      dst[r * dp + f] = __ldg(src + e);
    }
  }
}
__device__ __forceinline__ void stage_rows(float* dst,
                                           const __nv_bfloat16* src, int n,
                                           int d, int dp, bool vec) {
  if (vec) {
    const int q = d / 4;
    for (int e = threadIdx.x; e < n * q; e += kThreads) {
      const int r = e / q, c = e - r * q;
      const uint2 u = *reinterpret_cast<const uint2*>(
          src + (long long)r * d + 4 * c);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      *reinterpret_cast<float4*>(dst + r * dp + 4 * c) =
          make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  } else {
    for (int e = threadIdx.x; e < n * d; e += kThreads) {
      const int r = e / d, f = e - r * d;
      dst[r * dp + f] = __bfloat162float(src[e]);
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A group's partial chains of NR rows against NB basis rows:
// v[q * NB + b][c] = sum over t of U_b[32 t + 4 m + c] * x_q[32 t + 4 m + c]
// as one fmaf chain in t order, features at or past d skipped (lane
// 4 m + c of the first port's warp dot).  xr[q], ur[b]: shared rows,
// offset by 4 m.
template <int NR, int NB>
__device__ __forceinline__ void dot_chains(const float* const (&xr)[NR],
                                           const float* const (&ur)[NB],
                                           int m, int d,
                                           float (&v)[NR * NB][4]) {
#pragma unroll
  for (int n = 0; n < NR * NB; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[n][c] = 0.0f;
  const int full = d >> 5;
  auto slice = [&](int t) {
    float4 a[NR], b[NB];
#pragma unroll
    for (int q = 0; q < NR; ++q)
      a[q] = *reinterpret_cast<const float4*>(xr[q] + 32 * t);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      b[j] = *reinterpret_cast<const float4*>(ur[j] + 32 * t);
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float* s = v[q * NB + j];
        s[0] = fmaf(b[j].x, a[q].x, s[0]);
        s[1] = fmaf(b[j].y, a[q].y, s[1]);
        s[2] = fmaf(b[j].z, a[q].z, s[2]);
        s[3] = fmaf(b[j].w, a[q].w, s[3]);
      }
  };
  // one row and one basis row: every slice's loads in flight at once
  if constexpr (NR * NB == 1) {
#pragma unroll 8
    for (int t = 0; t < full; ++t) slice(t);
  } else {
#pragma unroll 2
    for (int t = 0; t < full; ++t) slice(t);
  }
  if (d & 31) {
    const int left = d - 32 * full - 4 * m;  // features of this thread left
    float4 a[NR], b[NB];
#pragma unroll
    for (int q = 0; q < NR; ++q)
      a[q] = *reinterpret_cast<const float4*>(xr[q] + 32 * full);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      b[j] = *reinterpret_cast<const float4*>(ur[j] + 32 * full);
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < left)
            v[q * NB + j][c] =
                fmaf(comp(b[j], c), comp(a[q], c), v[q * NB + j][c]);
  }
}

// The same for ||x_q||^2: mul-then-add chains, as the first port's norm.
template <int NR>
__device__ __forceinline__ void norm_chains(const float* const (&xr)[NR],
                                            int m, int d,
                                            float (&v)[NR][4]) {
#pragma unroll
  for (int n = 0; n < NR; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[n][c] = 0.0f;
  const int full = d >> 5;
  for (int t = 0; t < full; ++t) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(xr[q] + 32 * t);
      v[q][0] = __fadd_rn(v[q][0], __fmul_rn(a.x, a.x));
      v[q][1] = __fadd_rn(v[q][1], __fmul_rn(a.y, a.y));
      v[q][2] = __fadd_rn(v[q][2], __fmul_rn(a.z, a.z));
      v[q][3] = __fadd_rn(v[q][3], __fmul_rn(a.w, a.w));
    }
  }
  if (d & 31) {
    const int left = d - 32 * full - 4 * m;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(xr[q] + 32 * full);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < left)
          v[q][c] = __fadd_rn(v[q][c], __fmul_rn(comp(a, c), comp(a, c)));
    }
  }
}

// One level of the fold across a group: lanes l and l ^ (4 H) of the
// first port's warp (threads m and m ^ H) add their chains.  With N >= 2
// dots left the thread with bit H set keeps the upper half of them, its
// partner the lower half (each add is still a + b of the same two sums);
// with one dot left both keep it.  `base` counts the dots passed over.
template <int NP, int N, int H>
__device__ __forceinline__ void fold_level(float (&v)[NP][4], int m,
                                           int& base) {
  if constexpr (N >= 2) {
    constexpr int half = N / 2;
    const bool hi = (m & H) != 0;
#pragma unroll
    for (int q = 0; q < half; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float send = hi ? v[q][c] : v[q + half][c];
        const float keep = hi ? v[q + half][c] : v[q][c];
        v[q][c] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, H));
      }
    if (hi) base += half;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[0][c] = __fadd_rn(v[0][c], __shfl_xor_sync(kFull, v[0][c], H));
  }
}

// Folds N dots' chains (v[n][c], lane 4 m + c) over the 32 lanes in the
// first port's butterfly order.  Afterwards the thread holds dots
// base .. base + max(N / 8, 1) - 1 in out[]; it returns whether it is the
// one thread of its group that writes them (with fewer than 8 dots,
// several threads hold each).  Every thread of the warp must call it.
template <int N>
__device__ __forceinline__ bool fold(float (&v)[N][4], int m, int& base,
                                     float (&out)[N >= 8 ? N / 8 : 1]) {
  base = 0;
  fold_level<N, N, 4>(v, m, base);
  fold_level<N, (N >= 2 ? N / 2 : 1), 2>(v, m, base);
  fold_level<N, (N >= 4 ? N / 4 : 1), 1>(v, m, base);
  constexpr int kOut = N >= 8 ? N / 8 : 1;
#pragma unroll
  for (int q = 0; q < kOut; ++q)
    out[q] = __fadd_rn(__fadd_rn(v[q][0], v[q][2]),
                       __fadd_rn(v[q][1], v[q][3]));
  constexpr int dup = N >= 8 ? 0 : N == 4 ? 1 : N == 2 ? 3 : 7;
  return (m & dup) == 0;
}

template <typename T, bool kCost>
__global__ void __launch_bounds__(kThreads, 1)
narrow_kernel(const T* __restrict__ x, const float* __restrict__ U_in,
              const float* __restrict__ logdet_in,
              const int* __restrict__ size_in,
              const unsigned char* __restrict__ eligible,
              const float* __restrict__ tau, const int* __restrict__ budget,
              const float* __restrict__ cost,
              const float* __restrict__ cost_budget,
              unsigned char* __restrict__ mask, float* __restrict__ U_out,
              float* __restrict__ logdet_out, int* __restrict__ size_out,
              float* __restrict__ gains, int B, int k, int d, Layout lay,
              Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dp = lay.dp, kp = lay.kp, rb = lay.rows;
  float* Us = smem;               // [k][dp]
  float* xs = Us + k * dp;        // [rb][dp]
  float* cj = xs + rb * dp;       // [k]: alpha <U_j, x> of the row appended
  float* D = cj + (k + 3) / 4 * 4;  // [rb][kp]: <U_j, x_r>
  float* sq = D + rb * kp;        // [rb]: ||x_r||^2
  float* vv = sq + rb;            // [rb]: sum_j (alpha <U_j, x_r>)^2
  float* gs = vv + rb;            // [rb]: the gain last scored
  float* cs = gs + rb;            // [rb]: the row's cost (cost mode)
  int* firsts = reinterpret_cast<int*>(cs + rb);  // [2][8] ballots
  unsigned* ebits = reinterpret_cast<unsigned*>(firsts + 16);  // [4]

  const int l = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = tid / kGroup, m = tid % kGroup;
  const long long u0 = (long long)l * k * d;
  const T* xl = x + (long long)l * B * d;
  const bool vec_u = d % 4 == 0 && reinterpret_cast<uintptr_t>(U_in) % 16 == 0;
  const bool vec_x =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;

  // the pads past d stay zero for the whole launch
  if (dp != d) {
    for (int e = tid; e < (k + rb) * (dp - d); e += kThreads) {
      const int r = e / (dp - d);
      Us[r * dp + d + (e - r * (dp - d))] = 0.0f;  // rows of U, then of xs
    }
  }
  stage_rows(Us, U_in + u0, k, d, dp, vec_u);

  const int size0 = size_in[l];
  const float tau_l = tau[l];
  const int budget_l = budget[l];
  float ld = logdet_in[l];
  int n_acc = 0;
  const float cbud = kCost ? cost_budget[l] : 0.0f;
  float spent = 0.0f;
  int par = 0;  // which set of ballots the walk writes next

  // D[r][j] = <U_j, x_r> for the block's rows [r0, r1) and basis rows
  // [j0, j1), 4 rows by 4 basis rows a group (warps whose groups all lie
  // past the work skip a round as a whole: the fold's shuffles need every
  // lane)
  auto project = [&](int r0, int r1, int j0, int j1) {
    const int njq = (j1 - j0 + 3) / 4, ntile = (r1 - r0 + 3) / 4 * njq;
    for (int t0 = warp * 4; t0 < ntile; t0 += kGroups) {
      const int tile = min(t0 + (grp & 3), ntile - 1);
      const int rq = tile / njq, jq = tile - rq * njq;
      const float* xr[4];
      const float* ur[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xr[q] = xs + min(r0 + 4 * rq + q, r1 - 1) * dp + 4 * m;
        ur[q] = Us + min(j0 + 4 * jq + q, j1 - 1) * dp + 4 * m;
      }
      float v[16][4], out[2];
      dot_chains<4, 4>(xr, ur, m, d, v);
      int base;
      fold<16>(v, m, base, out);
      if (t0 + (grp & 3) < ntile) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 4 * rq + (base + h) / 4;
          const int j = j0 + 4 * jq + (base + h) % 4;
          if (r < r1 && j < j1) D[r * kp + j] = out[h];
        }
      }
    }
  };
  // vv[r] += (alpha D[r][j])^2 for j in [j0, j1), in j order, by row r's
  // thread (the thread that scores it)
  auto extend = [&](int r0, int r1, int j0, int j1) {
    if (tid >= r0 && tid < r1) {
      float s = vv[tid];
#pragma unroll 8
      for (int j = j0; j < j1; ++j) {
        const float v = __fmul_rn(p.alpha, D[tid * kp + j]);
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
      vv[tid] = s;
    }
  };

  // row r's gain from its sum of squares vvr, and whether the rule
  // accepts it now
  auto score = [&](int r, float vvr, float& g) {
    const float d2 = fmaxf(
        __fsub_rn(__fadd_rn(1.0f, __fmul_rn(p.alpha, sq[r])), vvr), p.eps);
    g = logf(d2);
    if (p.scale != 1.0f) g = __fmul_rn(p.scale, g);
    const bool e = (ebits[r >> 5] >> (r & 31)) & 1u;
    if constexpr (kCost) {
      const float c = cs[r];
      return e && g >= __fmul_rn(tau_l, c) && n_acc < budget_l &&
             __fadd_rn(spent, c) <= cbud;
    } else {
      return e && g >= tau_l && n_acc < budget_l;
    }
  };

  for (int b0 = 0; b0 < B; b0 += rb) {
    const int nb = min(rb, B - b0);
    const long long row0 = (long long)l * B + b0;
    __syncthreads();  // the last block's rows are no longer read
    stage_rows(xs, xl + (long long)b0 * d, nb, d, dp, vec_x);
    cp_commit_wait_all();
    // the rows' eligibility and costs, for the rule
    bool elig = false;
    if (tid < nb) {
      elig = eligible[row0 + tid] != 0;
      cs[tid] = kCost ? cost[row0 + tid] : 0.0f;
      vv[tid] = 0.0f;
    }
    if (warp * 32 < rb) {
      const unsigned bits = __ballot_sync(kFull, elig);
      if (lane == 0) ebits[warp] = bits;
    }
    const int live0 = min(max(size0 + n_acc, 0), k);
    __syncthreads();  // U and the rows staged

    // -- phase 1: ||x_r||^2 and <U_j, x_r> for j < live0, every row
    const int nrq = (nb + 3) / 4;
    for (int w0 = 4 * warp; w0 < nrq; w0 += kGroups) {  // the warp's quads
      const int rq = min(w0 + (grp & 3), nrq - 1);
      const float* xr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xr[q] = xs + min(4 * rq + q, nb - 1) * dp + 4 * m;
      float v[4][4], out[1];
      norm_chains<4>(xr, m, d, v);
      int base;
      const bool own = fold<4>(v, m, base, out);
      const int r = 4 * rq + base;
      if (own && w0 + (grp & 3) < nrq && r < nb) sq[r] = out[0];
    }
    project(0, nb, 0, live0);
    __syncthreads();
    extend(0, nb, 0, live0);

    // -- phase 2: the walk, over a window of kWindow rows: rows [cur, upto)
    //    hold every dot with the live basis; a row past the window holds
    //    those of the basis at the block's start (live0) until the walk
    //    reaches it.  Once the lane's size reaches k every later append is
    //    dropped and the gains no longer move: one pass scores the rest,
    //    and every thread runs the rule down them.
    int cur = 0, upto = 0;
    bool scored = false;  // the window's rows [cur, upto) are scored
    while (cur < nb) {
      const bool full = size0 + n_acc >= k;
      if (cur == upto || full) {
        const int next = full ? nb : min(cur + kWindow, nb);
        const int live = min(max(size0 + n_acc, 0), k);
        if (next > upto && live > live0) {
          project(upto, next, live0, live);
          __syncthreads();
          extend(upto, next, live0, live);
        }
        upto = next;
        scored = false;
      }
      if (!scored) {  // one thread a row
        bool acc = false;
        if (tid >= cur && tid < upto) {
          float g;
          acc = score(tid, vv[tid], g);
          gs[tid] = g;
        }
        const unsigned bal = __ballot_sync(kFull, acc);
        if (lane == 0)
          firsts[par * 8 + warp] = bal ? warp * 32 + __ffs(bal) - 1 : kNone;
        __syncthreads();
      }
      if (full) {
        for (int r = cur; r < nb; ++r) {
          const float gr = gs[r];
          const bool e = (ebits[r >> 5] >> (r & 31)) & 1u;
          bool a;
          if constexpr (kCost) {
            const float c = cs[r];
            a = e && gr >= __fmul_rn(tau_l, c) && n_acc < budget_l &&
                __fadd_rn(spent, c) <= cbud;
            if (a) spent = __fadd_rn(spent, c);
          } else {
            a = e && gr >= tau_l && n_acc < budget_l;
          }
          if (a) {
            ld = __fadd_rn(ld, gr);
            ++n_acc;
          }
          if (tid == r) {
            mask[row0 + r] = a ? 1 : 0;
            gains[row0 + r] = gr;
          }
        }
        break;
      }
      const int4 f0 = *reinterpret_cast<const int4*>(firsts + par * 8);
      const int4 f1 = *reinterpret_cast<const int4*>(firsts + par * 8 + 4);
      const int first = min(min(min(f0.x, f0.y), min(f0.z, f0.w)),
                            min(min(f1.x, f1.y), min(f1.z, f1.w)));
      par ^= 1;
      if (tid >= cur && tid < upto && tid <= first) {
        mask[row0 + tid] = tid == first ? 1 : 0;
        gains[row0 + tid] = gs[tid];
      }
      if (first >= upto) {  // the window's rows are all rejected
        cur = upto;
        continue;
      }

      // -- phase 3: accept row `first`
      const float gf = gs[first];
      const float d2f = fmaxf(
          __fsub_rn(__fadd_rn(1.0f, __fmul_rn(p.alpha, sq[first])), vv[first]),
          p.eps);
      const int live = min(max(size0 + n_acc, 0), k);
      const int slot = size0 + n_acc;
      if constexpr (kCost) spent = __fadd_rn(spent, cs[first]);
      ld = __fadd_rn(ld, gf);
      ++n_acc;
      cur = first + 1;
      scored = false;
      if (slot < 0 || slot >= k) continue;  // past k_max: no row written
      // the append, each feature's chain in j order over the coefficients,
      // staged once
      const float rd = sqrtf(d2f);
      for (int j = tid; j < live; j += kThreads)
        cj[j] = __fmul_rn(p.alpha, D[first * kp + j]);
      __syncthreads();
      for (int f = tid; f < d; f += kThreads) {
        const float* uf = Us + f;
        float s = 0.0f;
        int j = 0;
#pragma unroll 4
        for (; j + 4 <= live; j += 4) {
          const float4 c = *reinterpret_cast<const float4*>(cj + j);
          s = fmaf(c.x, uf[j * dp], s);
          s = fmaf(c.y, uf[(j + 1) * dp], s);
          s = fmaf(c.z, uf[(j + 2) * dp], s);
          s = fmaf(c.w, uf[(j + 3) * dp], s);
        }
        for (; j < live; ++j) s = fmaf(cj[j], uf[j * dp], s);
        Us[slot * dp + f] = __fdiv_rn(__fsub_rn(xs[first * dp + f], s), rd);
      }
      __syncthreads();
      // the new basis row against the window's later rows, one row a group
      // (all its slices' loads in flight at once): the dot, the row's sum
      // of squares, and its score, so the next decision needs no pass
      {
        const int r = cur + grp;
        bool acc = false;
        if (warp * 4 < upto - cur) {  // the warp has rows: it folds
          const int rr = min(r, upto - 1);
          const float vv0 = vv[rr];
          const float* xr[1] = {xs + rr * dp + 4 * m};
          const float* ur[1] = {Us + slot * dp + 4 * m};
          float v[1][4], out[1];
          dot_chains<1, 1>(xr, ur, m, d, v);
          int base;
          fold<1>(v, m, base, out);
          if (r < upto) {
            const float vj = __fmul_rn(p.alpha, out[0]);
            const float vvr = __fadd_rn(vv0, __fmul_rn(vj, vj));
            float g;
            acc = score(r, vvr, g);
            if (m == 0) {
              D[r * kp + slot] = out[0];
              vv[r] = vvr;
              gs[r] = g;
            }
          }
        }
        const unsigned bal = __ballot_sync(kFull, acc && m == 0);
        if (lane == 0)
          firsts[par * 8 + warp] =
              bal ? cur + warp * 4 + (__ffs(bal) - 1) / kGroup : kNone;
        __syncthreads();
        scored = true;
      }
    }
  }
  cp_commit_wait_all();  // U's copies, when there was no row to wait with
  __syncthreads();
  for (int j = 0; j < k; ++j)
    for (int f = tid; f < d; f += kThreads)
      U_out[u0 + (long long)j * d + f] = Us[j * dp + f];
  if (tid == 0) {
    logdet_out[l] = ld;
    size_out[l] = size0 + n_acc;
  }
}

// The wide instance: the first port's loop, U in the lane's slice of U_out.
template <typename T, bool kCost>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const T* __restrict__ x, const float* __restrict__ U_in,
            const float* __restrict__ logdet_in,
            const int* __restrict__ size_in,
            const unsigned char* __restrict__ eligible,
            const float* __restrict__ tau, const int* __restrict__ budget,
            const float* __restrict__ cost,
            const float* __restrict__ cost_budget,
            unsigned char* __restrict__ mask, float* __restrict__ U_out,
            float* __restrict__ logdet_out, int* __restrict__ size_out,
            float* __restrict__ gains, int B, int k, int d, Params p) {
  extern __shared__ float dots[];  // [k + 1]: <U_j, x_i>, then ||x_i||^2
  const int l = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xl = x + (long long)l * B * d;
  const long long u0 = (long long)l * k * d;
  float* Us = U_out + u0;
  for (int t = threadIdx.x; t < k * d; t += kThreads) Us[t] = U_in[u0 + t];
  const int size0 = size_in[l];
  const float tau_l = tau[l];
  const int budget_l = budget[l];
  float ld = logdet_in[l];
  int n_acc = 0;
  const float cbud = kCost ? cost_budget[l] : 0.0f;
  float spent = 0.0f;
  for (int i = 0; i < B; ++i) {
    const T* xc = xl + (long long)i * d;
    // the last append written, the last row's dots read
    __syncthreads();
    const int live = min(max(size0 + n_acc, 0), k);
    for (int task = warp; task <= live; task += kWarps) {
      float s = 0.0f;
      if (task < live) {
        const float* uj = Us + task * d;
        for (int f = lane; f < d; f += 32) s = fmaf(uj[f], load_f(xc + f), s);
      } else {
        for (int f = lane; f < d; f += 32)
          s = __fadd_rn(s, __fmul_rn(load_f(xc + f), load_f(xc + f)));
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) dots[task < live ? task : k] = s;
    }
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
          Us[row * d + f] = __fdiv_rn(__fsub_rn(load_f(xc + f), s), rd);
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
  if (threadIdx.x == 0) {
    logdet_out[l] = ld;
    size_out[l] = size0 + n_acc;
  }
}

struct Args {
  const void *x, *U, *logdet, *size, *eligible, *tau, *budget, *cost,
      *cost_budget;
  void *mask, *U_out, *logdet_out, *size_out, *gains;
  int L, B, k, d;
};

template <typename T, bool kCost>
cudaError_t launch_mode(const Args& a, const Params& p, int wide,
                        cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const float* U = static_cast<const float*>(a.U);
  const float* ld = static_cast<const float*>(a.logdet);
  const int* size = static_cast<const int*>(a.size);
  const unsigned char* el = static_cast<const unsigned char*>(a.eligible);
  const float* tau = static_cast<const float*>(a.tau);
  const int* bud = static_cast<const int*>(a.budget);
  const float* cost = static_cast<const float*>(a.cost);
  const float* cb = static_cast<const float*>(a.cost_budget);
  unsigned char* mask = static_cast<unsigned char*>(a.mask);
  float* U_out = static_cast<float*>(a.U_out);
  float* ld_out = static_cast<float*>(a.logdet_out);
  int* size_out = static_cast<int*>(a.size_out);
  float* gains = static_cast<float*>(a.gains);
  if (wide) {
    const size_t smem = (size_t)(a.k + 1) * 4;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          wide_kernel<T, kCost>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    wide_kernel<T, kCost><<<a.L, kThreads, smem, stream>>>(
        x, U, ld, size, el, tau, bud, cost, cb, mask, U_out, ld_out,
        size_out, gains, a.B, a.k, a.d, p);
    return cudaGetLastError();
  }
  const int rows = rows_per_block(a.k, a.d, 227 * 1024);
  if (rows < kMinRows) return cudaErrorInvalidValue;
  const Layout lay{Layout::pad(a.d), a.k | 1, rows};
  const size_t smem = (size_t)Layout::floats(a.k, a.d, rows) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      narrow_kernel<T, kCost>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  narrow_kernel<T, kCost><<<a.L, kThreads, smem, stream>>>(
      x, U, ld, size, el, tau, bud, cost, cb, mask, U_out, ld_out, size_out,
      gains, a.B, a.k, a.d, lay, p);
  return cudaGetLastError();
}

// cost (L, B) f32 and cost_budget (L,) f32 select the knapsack cost mode,
// nullptr the cardinality mode.
template <typename T>
cudaError_t launch_dtype(const Args& a, const Params& p, int wide,
                         cudaStream_t stream) {
  return a.cost ? launch_mode<T, true>(a, p, wide, stream)
                : launch_mode<T, false>(a, p, wide, stream);
}

}  // namespace

// wide: the instance the wrapper picked (logdet_accept.instance): 0 keeps
// U, a block of rows and its dot matrix in shared memory, 1 keeps U in
// U_out.
extern "C" int logdet_accept_launch(
    const void* x, int x_is_bf16, const void* U, const void* logdet,
    const void* size, const void* eligible, const void* tau,
    const void* budget, const void* cost, const void* cost_budget,
    void* mask, void* U_out, void* logdet_out, void* size_out, void* gains,
    int L, int B, int k, int d, float alpha, float scale, float eps, int wide,
    void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  if (k <= 0 || d <= 0 || (wide && (long long)(k + 1) * 4 > 227 * 1024))
    return (int)cudaErrorInvalidValue;
  const Params p{alpha, scale, eps};
  const Args a{x,    U,      logdet,     size,     eligible, tau,   budget,
               cost, cost_budget, mask,   U_out,    logdet_out, size_out,
               gains, L,     B,          k,        d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? launch_dtype<__nv_bfloat16>(a, p, wide, s)
                         : launch_dtype<float>(a, p, wide, s));
}
