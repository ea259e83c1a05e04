// The fused marginals of FacilityLocation and ExemplarClustering
// (facility_marginals.cu, exemplar_marginals.cu): a register-blocked SIMT
// tile for Hopper, the product of a candidate block with a replicated
// (r, d) reference set and the lanes' residual sums in one kernel,
//
//     out[l, i] = sum_j Rule::residual(s[l, j], v(i, j)),
//
// with v(i, j) the Rule's value of acc = <cand_i, ref_j> (reference_tile.cuh:
// Facility max(acc, 0); Exemplar max((refsq_j - 2 acc) + sq_i, 0)).  Its
// product loop (product() below) is also the product of logdet_marginals.cu,
// whose columns are the lanes' live basis rows: one GEMM loop for the three.
//
// What bounds it: at the filter shape (L = 37, C = 2^20, d = r = 256, f32)
// the product is C r d = 6.9e10 FMAs, 2.05 ms at the card's FFMA peak, and
// the epilogue 3 operations per (lane, row, column), ~0.9 ms of issue
// slots: bound by operations.  A 4 x 4 micro tile reads 2 bytes of shared
// memory per FMA, twice what the SM's 128 B per clock can feed 128 FP32
// lanes, so the design is the register-blocked SIMT GEMM:
//  * product: a CTA of 256 threads owns 128 candidate rows and walks the r
//    columns in 128-wide tiles.  Each thread keeps an 8 x 8 block of sums
//    (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and
//    64 + tx*4 + {0..3}), so four 16-byte shared loads feed 64 FMAs (1 byte
//    per FMA); a warp is 4 x 8 threads, so its loads touch 64 and 128
//    contiguous bytes and broadcast the rest.  d is staged 16 deep, cand
//    transposed to [k][row] and ref to [k][col], double-buffered: the next
//    slice is loaded into registers (a warp reads 8 rows of 64 contiguous
//    bytes, 16 bytes a thread when d % 4 == 0) while the FMAs run on the
//    current one, then stored with 16-byte row groups XOR-swizzled so the
//    transposed stores have no bank conflict; one barrier per slice.
//  * epilogue: the 128 x 128 value tile is written column-major ([col][row],
//    16-byte row groups XOR-swizzled by (col / 4) % 8 so both its writes and
//    its reads are free of bank conflicts) over the staging buffers, and the
//    lanes' 128-column state slice beside it as [col][lane].  An item is a
//    block of 4 lanes x 4 rows over one part of the tile's columns: per
//    column one 16-byte load of 4 values and one of 4 states feed 16
//    residuals (2 bytes per residual).  The columns are split into 1, 2, 4
//    or 8 parts so the items fill the CTA's rounds (one lane alone would
//    leave 7 of 8 warps idle), and the parts' sums meet in a fixed tree of
//    warp shuffles.  A block's running sum waits in shared memory between
//    column tiles, read and written only by the lane that owns it: no float
//    atomics, so a repeated launch gives the same bits.
//  * lanes: a shared (C, d) block serves a group of up to kMaxLaneGroup
//    lanes (a wider grid is split into groups, each recomputing the
//    product); a per-lane (L, C, d) block gives one lane per CTA.  At 37
//    lanes a CTA takes 104 KiB of shared memory and at most 128 registers a
//    thread, so two CTAs share an SM and one's epilogue and barriers
//    overlap the other's FMAs.
//
// Numbers it keeps: every product is one fmaf chain over k = 0, 1, ...,
// d - 1, with the k past d staged as 0 in 16-deep slices (sims::tile
// stages 32-deep ones: a zero adds exactly 0 either way), so the marginals
// see the similarity and distance bits of facility_accept and
// exemplar_accept; no TF32, no tensor cores; bf16 candidates are widened
// as they are staged; Exemplar's row norms come from reftile::row_sq.  Each (lane, row) sum adds its residuals part by
// part in column order, the parts in a fixed tree.  Rows past C, columns past r and lanes past L are masked (their
// states read as 0, their sums never written), not padded in memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "reference_tile.cuh"

namespace mtile {

constexpr int kThreads = 256;  // a 16 x 16 thread grid, 8 x 8 sums each
constexpr int kRows = 128;     // candidate rows per CTA
constexpr int kCols = 128;     // reference columns per tile
constexpr int kDepth = 16;     // k per staged slice
constexpr int kMicro = 8;
constexpr int kMaxLaneGroup = 128;

struct Stage {
  float a[2][kDepth][kRows];  // cand slices, [k][row]
  float b[2][kDepth][kCols];  // ref slices, [k][col]
};
constexpr size_t kValueBytes = sizeof(float) * kCols * kRows;
constexpr size_t kTileBytes =
    kValueBytes > sizeof(Stage) ? kValueBytes : sizeof(Stage);

// The thread's place in the 16 x 16 grid: a warp is 4 (ty) x 8 (tx).
__device__ __forceinline__ int grid_row() {
  return ((threadIdx.x >> 6) << 2) + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int grid_col() {
  return (((threadIdx.x >> 5) & 1) << 3) + (threadIdx.x & 7);
}
// Row (or column) of micro index m in 0..7 for grid position t.
__device__ __forceinline__ int micro_at(int t, int m) {
  return ((m >> 2) << 6) + (t << 2) + (m & 3);
}

// k .. k + 3 of a row (nullptr: a row past the edge, read as 0), widened to
// f32.  kVec: d % 4 == 0 and the row 16-byte aligned (8 for bf16), so the
// four are in range together and one load takes them.
template <typename T, bool kVec>
__device__ __forceinline__ float4 load4(const T* __restrict__ row, int k,
                                        int d) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row == nullptr) return v;
  if constexpr (kVec) {
    if (k < d) {
      if constexpr (std::is_same<T, float>::value) {
        v = __ldg(reinterpret_cast<const float4*>(row + k));
      } else {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + k));
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
  } else {
    if (k < d) v.x = sims::to_f(row[k]);
    if (k + 1 < d) v.y = sims::to_f(row[k + 1]);
    if (k + 2 < d) v.z = sims::to_f(row[k + 2]);
    if (k + 3 < d) v.w = sims::to_f(row[k + 3]);
  }
  return v;
}

// Where a stage row (k) keeps the 16-byte group of rows 4g .. 4g + 3: the
// groups are XOR-swizzled by 2 ((k / 4) % 4), so the transposed stores of
// a warp (8 rows x 4 k-quads) hit 32 different banks and a fragment's
// 16-byte loads stay whole and in order.
__device__ __forceinline__ int stage_group(int k, int g) {
  return (g ^ (((k >> 2) & 3) << 1)) << 2;
}
__device__ __forceinline__ int stage_at(int k, int row) {
  return stage_group(k, row >> 2) | (row & 3);
}

// The columns of a product tile, two ways:
//  * RefRows: rows col0 .. col0 + 127 of one row-major (r, d) f32 matrix
//    (the facility and exemplar reference set);
//  * RowPair: any rows gathered from memory (logdet_marginals.cu takes the
//    lanes' live basis rows): thread t stages the tile's columns q = t / 4
//    and q + 64, whose f32 rows (d values) it passes as b0 and b1 (nullptr:
//    a column past the edge, read as 0).
struct RefRows {
  const float* __restrict__ ref;
  int r;
};
struct RowPair {
  const float* __restrict__ b0;
  const float* __restrict__ b1;
};

// acc[m][n] = sum_k cand[row0 + micro_at(ty, m)][k] * col_n[k], one fmaf
// chain over k in order, where col_n is the row of the tile's column
// micro_at(tx, n) (Cols above).  Every thread of the CTA must call it; it
// ends with a barrier, so the stage may be overwritten at once.
template <typename TC, bool kVec, typename Cols>
__device__ __forceinline__ void product(const TC* __restrict__ cand,
                                        long long C, const Cols& cols, int d,
                                        long long row0, int col0, Stage& st,
                                        float acc[kMicro][kMicro]) {
#pragma unroll
  for (int m = 0; m < kMicro; ++m)
#pragma unroll
    for (int n = 0; n < kMicro; ++n) acc[m][n] = 0.0f;
  // staging: thread t loads k = kq .. kq + 3 of candidate rows q and
  // q + 64 and of reference rows q and q + 64, so a warp reads 8 rows of
  // 64 contiguous bytes (32 for bf16 rows)
  const int q = threadIdx.x >> 2, kq = (threadIdx.x & 3) << 2;
  const TC* arow = cand + (row0 + q) * d;
  const bool a_ok = row0 + q < C, a2_ok = row0 + q + 64 < C;
  const float* brow = nullptr;
  bool b_ok = false, b2_ok = false;
  if constexpr (std::is_same<Cols, RefRows>::value) {
    brow = cols.ref + (long long)(col0 + q) * d;
    b_ok = col0 + q < cols.r;
    b2_ok = col0 + q + 64 < cols.r;
  }
  const int ty = grid_row(), tx = grid_col();
  // the next slice's staging loads: cand's while the first half of the
  // current slice's FMAs run, ref's during the second half, so only eight
  // registers hold them
  float4 pf[2];
  auto stash = [&](float (*dst)[kRows]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q + 64 * h;
      dst[kq][stage_at(kq, row)] = pf[h].x;
      dst[kq + 1][stage_at(kq + 1, row)] = pf[h].y;
      dst[kq + 2][stage_at(kq + 2, row)] = pf[h].z;
      dst[kq + 3][stage_at(kq + 3, row)] = pf[h].w;
    }
  };
  auto fetch_a = [&](int k0) {
    pf[0] = load4<TC, kVec>(a_ok ? arow : nullptr, k0 + kq, d);
    pf[1] = load4<TC, kVec>(a2_ok ? arow + 64LL * d : nullptr, k0 + kq, d);
  };
  auto fetch_b = [&](int k0) {
    if constexpr (std::is_same<Cols, RefRows>::value) {
      pf[0] = load4<float, kVec>(b_ok ? brow : nullptr, k0 + kq, d);
      pf[1] = load4<float, kVec>(b2_ok ? brow + 64LL * d : nullptr, k0 + kq,
                                 d);
    } else {
      pf[0] = load4<float, kVec>(cols.b0, k0 + kq, d);
      pf[1] = load4<float, kVec>(cols.b1, k0 + kq, d);
    }
  };
  // fragments of step kk: rows micro_at(ty, 0..7), columns micro_at(tx, 0..7)
  float fa[kMicro], fb[kMicro];
  auto fragments = [&](int buf, int kk, float* a, float* b) {
    const float4 a0 = *reinterpret_cast<const float4*>(
        &st.a[buf][kk][stage_group(kk, ty)]);
    const float4 a1 = *reinterpret_cast<const float4*>(
        &st.a[buf][kk][stage_group(kk, 16 + ty)]);
    const float4 b0 = *reinterpret_cast<const float4*>(
        &st.b[buf][kk][stage_group(kk, tx)]);
    const float4 b1 = *reinterpret_cast<const float4*>(
        &st.b[buf][kk][stage_group(kk, 16 + tx)]);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  };
  const int slices = (d + kDepth - 1) / kDepth;
  fetch_a(0);
  stash(st.a[0]);
  fetch_b(0);
  stash(st.b[0]);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < slices;
    // the other buffer was last read in slice s - 1, before the barrier
    if (more) fetch_a((s + 1) * kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      fragments(buf, kk, fa, fb);
      if (kk == kDepth / 2 && more) {
        stash(st.a[buf ^ 1]);
        fetch_b((s + 1) * kDepth);
      }
#pragma unroll
      for (int m = 0; m < kMicro; ++m)
#pragma unroll
        for (int n = 0; n < kMicro; ++n)
          acc[m][n] = fmaf(fa[m], fb[n], acc[m][n]);
    }
    if (more) stash(st.b[buf ^ 1]);
    __syncthreads();
  }
}

// Offset of the 16-byte group holding rows 4g .. 4g + 3 of column c in the
// value tile: groups are XOR-swizzled by (c / 4) % 8.
__device__ __forceinline__ int value_at(int c, int g) {
  return c * kRows + ((g ^ ((c >> 2) & 7)) << 2);
}

// Shared memory after the tile: the state slice [col][lane pitch], the
// sums of the 4-lane x 4-row blocks [16][blocks] and, for a Rule with row
// norms, sq and its scratch.
__host__ __device__ constexpr int lane_pitch(int lanes) {
  return (lanes + 3) & ~3;
}
__host__ __device__ constexpr int sum_blocks(int lanes) {
  return lane_pitch(lanes) / 4 * (kRows / 4);
}
template <class Rule>
size_t smem_bytes(int lanes) {
  return kTileBytes +
         sizeof(float) * ((size_t)kCols * lane_pitch(lanes) +
                          (size_t)16 * sum_blocks(lanes) +
                          (Rule::kRowNorms ? kRows + kThreads : 0));
}

template <class Rule, typename TC, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
kernel(const TC* __restrict__ cand, int cand_per_lane,
       const float* __restrict__ ref, Rule rule,
       const float* __restrict__ state, float* __restrict__ out, int L,
       long long C, int r, int d, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage& stage = *reinterpret_cast<Stage*>(smem_raw);
  float* V = reinterpret_cast<float*>(smem_raw);  // over the stage

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
  const int lp = lane_pitch(nl);
  const int n_blocks = sum_blocks(nl);
  float* St = reinterpret_cast<float*>(smem_raw + kTileBytes);  // [col][lp]
  float* sums = St + kCols * lp;     // [16][n_blocks]
  float* sq = sums + 16 * n_blocks;  // [kRows], then [kThreads] scratch
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x;
  if constexpr (Rule::kRowNorms) {
    reftile::row_sq(x, C, d, row0, sq + kRows, sq);
    reftile::row_sq(x, C, d, row0 + kRows / 2, sq + kRows, sq + kRows / 2);
  }

  const int ty = grid_row(), tx = grid_col();
  const bool vec_out = (C & 3) == 0;
  // the columns of a tile are split into 1, 2, 4 or 8 parts: the fewest
  // (each part costs a level of shuffles) that fill the CTA's rounds of
  // residual items to within 15% (37 lanes: 4 parts, 5 full rounds; one
  // lane: 8 parts, one round)
  const int nlq = lp / 4;
  int parts = 1;
  while (parts < 8) {
    const int rounds = (nlq * parts + 7) / 8;  // of kThreads items
    if (rounds * 8 * 20 <= nlq * parts * 23) break;
    parts *= 2;
  }
  const int span = 32 / parts, part_cols = kCols / parts;
  const int n_items = 32 * nlq * parts;
  for (int col0 = 0; col0 < r; col0 += kCols) {
    // the value tile
    {
      float v[kMicro][kMicro];
      product<TC, kVec>(x, C, RefRows{ref, r}, d, row0, col0, stage, v);
#pragma unroll
      for (int n = 0; n < kMicro; ++n) {
        const int c = micro_at(tx, n);
        const int cc = min(col0 + c, r - 1);
#pragma unroll
        for (int m = 0; m < kMicro; ++m) {
          float a = v[m][n];
          if constexpr (Rule::kRectify) a = fmaxf(a, 0.0f);
          v[m][n] = rule.value(a, cc,
                               Rule::kRowNorms ? sq[micro_at(ty, m)] : 0.0f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(V + value_at(c, h * 16 + ty)) =
              make_float4(v[4 * h][n], v[4 * h + 1][n], v[4 * h + 2][n],
                          v[4 * h + 3][n]);
      }
    }
    // the lanes' state slice; columns past r and lanes past nl read as 0,
    // which adds exactly 0 (a value is >= 0, a state past r is 0)
    for (int t = tid; t < kCols * lp; t += kThreads) {
      const int l = t / kCols, c = t % kCols;
      St[c * lp + l] = (l < nl && col0 + c < r)
          ? __ldg(state + (long long)(l0 + l) * r + col0 + c) : 0.0f;
    }
    __syncthreads();

    const int nc4 = min(kCols, (r - col0 + 3) & ~3);
    const bool last = col0 + kCols >= r;
    // the residual items: (lane quad, row quad, column part); a warp holds
    // one lane quad, 32 / parts row quads and every part, so every lane of
    // a working warp takes part in the shuffles
    for (int it = tid; it < n_items; it += kThreads) {
      const int wi = it >> 5, ln = it & 31;
      const int part = ln / span;
      const int lq = wi / parts;
      const int rq = (wi % parts) * span + ln % span;
      float p[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) p[a][m] = 0.0f;
      const float* sl = St + lq * 4;
      const int c_end = min((part + 1) * part_cols, nc4);
      for (int c0 = part * part_cols; c0 < c_end; c0 += 4) {
        const float* vc = V + c0 * kRows + ((rq ^ ((c0 >> 2) & 7)) << 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v4 = *reinterpret_cast<const float4*>(vc + u * kRows);
          const float4 s4 = *reinterpret_cast<const float4*>(sl + (c0 + u) * lp);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int m = 0; m < 4; ++m)
              p[a][m] += Rule::residual(ss[a], vv[m]);
        }
      }
      // the parts' sums, in one fixed tree over the lanes (every lane of
      // the warp ends with the same bits)
      for (int o = span; o < 32; o <<= 1)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            p[a][m] += __shfl_xor_sync(0xffffffffu, p[a][m], o);
      if (part != 0) continue;
      float* mine = sums + lq * 32 + rq;   // sum e at mine[e * n_blocks]
      if (col0 != 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            p[a][m] = mine[(a * 4 + m) * n_blocks] + p[a][m];
      }
      if (!last) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int m = 0; m < 4; ++m) mine[(a * 4 + m) * n_blocks] = p[a][m];
        continue;
      }
      const long long row = row0 + rq * 4;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int l = lq * 4 + a;
        if (l >= nl) break;
        float* o = out + (long long)(l0 + l) * C + row;
        if (vec_out && row + 3 < C) {
          *reinterpret_cast<float4*>(o) = make_float4(p[a][0], p[a][1],
                                                      p[a][2], p[a][3]);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (row + m < C) o[m] = p[a][m];
        }
      }
    }
    __syncthreads();  // V (the next stage) and St are rewritten next tile
  }
}

template <class Rule, typename TC, bool kVec>
cudaError_t launch_t(const void* cand, int cand_per_lane, const void* ref,
                     const Rule& rule, const void* state, void* out, int L,
                     long long C, int r, int d, cudaStream_t stream) {
  const int group = cand_per_lane ? 1 : (L < kMaxLaneGroup ? L : kMaxLaneGroup);
  const size_t smem = smem_bytes<Rule>(group);
  cudaError_t e = cudaFuncSetAttribute(
      kernel<Rule, TC, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long row_tiles = (C + kRows - 1) / kRows;
  const int lane_blocks = cand_per_lane ? L : (L + group - 1) / group;
  if (row_tiles > 0x7fffffffLL || lane_blocks > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, lane_blocks);
  kernel<Rule, TC, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const TC*>(cand), cand_per_lane,
      static_cast<const float*>(ref), rule, static_cast<const float*>(state),
      static_cast<float*>(out), L, C, r, d, group);
  return cudaGetLastError();
}

template <class Rule, typename TC>
cudaError_t launch_dtype(const void* cand, int cand_per_lane, const void* ref,
                         const Rule& rule, const void* state, void* out,
                         int L, long long C, int r, int d,
                         cudaStream_t stream) {
  // 16-byte loads of the reference rows and 4-element loads of the
  // candidate rows need d % 4 == 0 and aligned bases
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cand) % (4 * sizeof(TC)) == 0 &&
                   reinterpret_cast<uintptr_t>(ref) % 16 == 0;
  return vec ? launch_t<Rule, TC, true>(cand, cand_per_lane, ref, rule, state,
                                        out, L, C, r, d, stream)
             : launch_t<Rule, TC, false>(cand, cand_per_lane, ref, rule,
                                         state, out, L, C, r, d, stream);
}

// Launch the marginals of cand (C, d) shared or (L, C, d) per lane, f32 or
// bf16, against ref (r, d) f32 and state (L, r) f32 into out (L, C) f32.
template <class Rule>
cudaError_t launch(const void* cand, int cand_is_bf16, int cand_per_lane,
                   const void* ref, const Rule& rule, const void* state,
                   void* out, int L, long long C, int r, int d,
                   cudaStream_t stream) {
  if (L <= 0 || C <= 0) return cudaSuccess;
  if (r <= 0 || d < 0) return cudaErrorInvalidValue;
  return cand_is_bf16
      ? launch_dtype<Rule, __nv_bfloat16>(cand, cand_per_lane, ref, rule,
                                          state, out, L, C, r, d, stream)
      : launch_dtype<Rule, float>(cand, cand_per_lane, ref, rule, state, out,
                                  L, C, r, d, stream);
}

}  // namespace mtile
