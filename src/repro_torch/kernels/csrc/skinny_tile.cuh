// The persistent skinny tile of graph_cut_marginals.cu and
// weighted_coverage_marginals.cu: for x (C, d) shared by L >= 2 lanes,
//
//     out[l, i] = epilogue( sum_f x[i, f] * c[l, f] )
//
// with the coefficient rows c and the epilogue a compile-time Policy:
//
//  * GraphCut:          c_l = t - 2 lam s_l, gain = acc - lam ||x_i||^2
//                       (||x_i||^2 from the staged slices);
//  * WeightedCoverage:  c_l = s_l (the lanes' remaining weights), gain =
//                       acc, no norm pass.
//
// Both replace the skinny (C, d) x (d, L) product of a TPU kernel
// (src/repro/kernels/graph_cut_marginals.py, _gc_kernel, and
// weighted_coverage_marginals.py, _wc_kernel).  At the filter shape
// (L = 37, C = 1,048,576, d = 256, f32) the 1 GiB of x read once and the
// 155 MB (L, C) output take 0.37 ms at 3.35 TB/s, and the 2 L C d = 2.0e10
// operations 0.30 ms at 67 TFLOP/s of f32: both limits are near, so x has
// to stream at near the memory's rate while the FMAs keep up.
//
// Design:
//  * The grid holds as many CTAs as fit on the SMs (two per SM at L <= 40),
//    and each walks items of 256 rows of x by one lane tile (the lane count
//    rounded up to 8, 40 at L = 37; more than 64 lanes are walked in tiles
//    of 64, each item re-reading its rows from L2), advancing its walk one
//    slice at a time (no division per slice).  The coefficient rows are
//    formed once per CTA into shared memory (40 KiB at L = 37, d = 256), in
//    chunks of features where they do not fit.
//  * x streams through a ring of 2 or 3 shared-memory stages of 256 rows
//    x 32 features with cp.async (16 bytes a thread, each row slice 128
//    contiguous bytes), the next slice in flight while the FMAs run on
//    this one; one barrier per slice.  Row slices are not padded: their
//    16-byte pieces are XOR-swizzled by row / 8, so a warp's fragment
//    loads and the norm pass's loads do not conflict.
//  * A thread keeps 8 rows x NJ lanes of sums in registers (rows 8 rg + m,
//    lanes tx + 8 j; 40 sums at L = 37): per 4 features it loads 8 row and
//    NJ coefficient fragments of 16 bytes for 32 NJ FMAs.
//  * GraphCut's ||x_i||^2 comes from the staged slices, not from a second
//    read of x: each row's chain is kept in a register of one thread
//    across slices.
//  * The gains go straight from registers to memory: a thread stores 8
//    consecutive rows of a lane as two 16-byte stores, so a warp writes 8
//    runs of 128 contiguous bytes.
//
// Numbers it keeps: every sum is one fixed-order fmaf chain over features
// 0 .. d - 1 (the product per (row, lane), ||x_i||^2 per row), with no
// atomics and no split over d, so a repeated launch gives the same bits,
// and on dyadic data (every product and sum exact) the gains equal the
// plain versions' bit for bit.  GraphCut's gain is acc - lam * sq with a
// rounded product, the plain version's order.  The GraphCut policy's code
// is the graph cut tile's token for token (`if constexpr` drops the other
// policy's lines), so its SASS does not depend on the second user.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace skinny {

// c_l = t - 2 lam s_l; gain = acc - lam ||x_i||^2
struct GraphCut {
  static constexpr bool kNorm = true;
};
// c_l = s_l; gain = acc
struct WeightedCoverage {
  static constexpr bool kNorm = false;
};

constexpr int kThreads = 256;
constexpr int kGroups = 8;        // lane groups: a thread's lanes tx + 8 j
constexpr int kRowsPer = 8;       // rows of a thread's register block
constexpr int kRows = kThreads / kGroups * kRowsPer;  // x rows per item
constexpr int kDepth = 32;        // features per ring stage
constexpr int kMaxTile = 64;      // lanes per lane tile (8 per thread)
constexpr int kCoefBytes = 80 * 1024;

// Up to 40 lanes (NJ <= 5) two CTAs share an SM, each with a ring of two
// stages (one in flight while the other is computed) and at most 128
// registers a thread; wider lane tiles need more registers, so one CTA
// per SM with a ring of three.
template <int NJ>
__host__ __device__ constexpr int stages() {
  return NJ <= 5 ? 2 : 3;
}

static_assert(kRows == kThreads, "one norm row per thread");

// A ring stage holds kRows row slices of kDepth features, each slice as
// kPerRow 16-byte pieces; piece p of row r sits at p ^ ((r / 8) % kPerRow),
// so the four rows each quarter of a warp reads at once (8 apart) fall on
// distinct banks without padding, and a thread's 8 rows share one swizzle.
template <typename T>
struct Ring {
  static constexpr int kChunk = 16 / (int)sizeof(T);  // elements per piece
  static constexpr int kPerRow = kDepth / kChunk;     // pieces per row slice
  static constexpr int kElems = kRows * kDepth;       // elements per stage
  static constexpr int kCopies = kRows * kPerRow / kThreads;  // per thread
  // element offset of feature kk (a multiple of 4) of row r in a stage
  __device__ static int at(int r, int kk) {
    return r * kDepth +
           (((kk / kChunk) ^ ((r >> 3) & (kPerRow - 1))) * kChunk) +
           kk % kChunk;
  }
};

// This CTA's walk over (item, slice): items blockIdx.x, + gridDim.x, ...;
// an item is kRows rows of x by one lane tile, its slices kDepth features
// each.  Advanced one slice at a time, so no division runs per slice.
struct Walk {
  long long item, row0;
  int lt, s;
  __device__ void start(long long first, int tiles) {
    item = first;
    s = 0;
    row0 = (item / tiles) * kRows;
    lt = (int)(item % tiles);
  }
  __device__ void next(int ns, int tiles) {
    if (++s < ns) return;
    start(item + gridDim.x, tiles);
  }
};

// Features of the coefficient rows held at once: all of d (rounded up to
// kDepth) when a lane tile's rows fit in kCoefBytes, else the most that do.
inline int coef_depth(int lt, int d) {
  const int fit = (kCoefBytes / (4 * lt) - 4) / kDepth * kDepth;
  const int dd = (d + kDepth - 1) / kDepth * kDepth;
  return dd < fit ? dd : fit;
}

template <typename T, int NJ>
size_t smem_bytes(int lt, int dc) {
  return sizeof(T) * stages<NJ>() * Ring<T>::kElems +
         sizeof(float) * ((size_t)lt * (dc + 4) + kRows);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void put_zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void put_zero(__nv_bfloat16& v) {
  v = __float2bfloat16(0.0f);
}

// Four staged features of a row, widened to f32.
__device__ __forceinline__ float4 frag4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 frag4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// kVec: d % (16 / sizeof(T)) == 0 and x 16-byte aligned, so every 16-byte
// piece of a row slice is in range whole (cp.async); else plain loads.
// total, two_lam and lam are GraphCut's (WeightedCoverage reads none).
template <typename P, typename T, int NJ, bool kVec>
__global__ void __launch_bounds__(kThreads, NJ <= 5 ? 2 : 1)
lanes_tile_kernel(const T* __restrict__ x, const float* __restrict__ total,
                  const float* __restrict__ state, float two_lam, float lam,
                  float* __restrict__ out, int L, long long C, int d,
                  int dc) {
  using R = Ring<T>;
  constexpr int LT = kGroups * NJ;
  constexpr int kStages = stages<NJ>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* coef = reinterpret_cast<float*>(smem_raw +
                                         sizeof(T) * kStages * R::kElems);
  const int cpitch = dc + 4;               // coef [LT][cpitch]
  float* sq = coef + LT * cpitch;          // [kRows]

  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = ((tid >> 5) << 2) + (lane & 3);  // rows 8 rg + m
  const int tx = lane >> 2;                       // lanes tx + 8 j
  const int nrow = ((tid & 31) << 3) + (tid >> 5);  // the row of its norm
  const long long blocks = (C + kRows - 1) / kRows;
  const int tiles = (L + LT - 1) / LT;
  const long long items = blocks * tiles;
  const int ns = (d + kDepth - 1) / kDepth;  // slices per item
  const int chunk = dc / kDepth;             // slices per coefficient chunk
  const long long n_it =
      blockIdx.x < items ? ((items - 1 - blockIdx.x) / gridDim.x + 1) * ns
                         : 0;

  // stage the slice of walk position `w` into ring buffer `buf`
  auto stage_slice = [&](const Walk& w, int buf) {
    T* dst = ring + buf * R::kElems;
    const int k0 = w.s * kDepth;
#pragma unroll
    for (int i = 0; i < R::kCopies; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / R::kPerRow, kc = (c % R::kPerRow) * R::kChunk;
      const long long row = w.row0 + r;
      const int k = k0 + kc;
      T* to = dst + R::at(r, kc);
      if constexpr (kVec) {
        const bool ok = row < C && k < d;
        cp_async16(to, ok ? x + row * d + k : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < R::kChunk; ++e) {
          if (row < C && k + e < d) to[e] = x[row * d + k + e];
          else put_zero(to[e]);
        }
      }
    }
  };

  Walk cur, ahead;  // the slice computed, the next slice staged
  cur.start(blockIdx.x, tiles);
  ahead = cur;
  int buf = 0, ahead_buf = 0;
  long long staged = 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (staged < n_it) {
      stage_slice(ahead, ahead_buf);
      ahead.next(ns, tiles);
      ++staged;
      ahead_buf = ahead_buf + 1 == kStages ? 0 : ahead_buf + 1;
    }
    cp_commit();
  }
  float acc[kRowsPer][NJ];
  float norm = 0.0f;    // ||x||^2 of row nrow, carried across slices
  long long held = -1;  // (lane tile, chunk) of the coefficients in coef
  const int sw = rg & (R::kPerRow - 1);  // the swizzle of the thread's rows
  for (long long it = 0; it < n_it; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // slice it landed; the buffer of slice it - 1 is free
    if (staged < n_it) {
      stage_slice(ahead, ahead_buf);
      ahead.next(ns, tiles);
      ++staged;
      ahead_buf = ahead_buf + 1 == kStages ? 0 : ahead_buf + 1;
    }
    cp_commit();
    const int s = cur.s, lt = cur.lt;
    if (s == 0) {
#pragma unroll
      for (int m = 0; m < kRowsPer; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[m][j] = 0.0f;
      norm = 0.0f;
    }
    const long long key = (long long)lt * ns + s / chunk;
    if (key != held) {
      // the coefficient rows for the tile's lanes and this chunk of
      // features (0 past L and past d)
      const int f0 = (s / chunk) * dc;
      for (int e = tid; e < LT * dc; e += kThreads) {
        const int j = e / dc, f = e % dc;
        const int l = lt * LT + j, k = f0 + f;
        if constexpr (P::kNorm) {
          coef[j * cpitch + f] =
              (l < L && k < d)
                  ? __fsub_rn(__ldg(total + k),
                              __fmul_rn(two_lam,
                                        __ldg(state + (long long)l * d + k)))
                  : 0.0f;
        } else {
          coef[j * cpitch + f] =
              (l < L && k < d) ? __ldg(state + (long long)l * d + k) : 0.0f;
        }
      }
      __syncthreads();
      held = key;
    }
    const T* xs = ring + buf * R::kElems;
    if constexpr (P::kNorm) {
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 4) {
        const float4 v = frag4(xs + R::at(nrow, kk));
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
    const T* xr = xs + kRowsPer * rg * kDepth;
    const float* cs = coef + (s % chunk) * kDepth;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 4) {
      const int off = ((kk / R::kChunk) ^ sw) * R::kChunk + kk % R::kChunk;
      float4 a[kRowsPer], b[NJ];
#pragma unroll
      for (int m = 0; m < kRowsPer; ++m) a[m] = frag4(xr + m * kDepth + off);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            cs + (tx + kGroups * j) * cpitch + kk);
#pragma unroll
      for (int m = 0; m < kRowsPer; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[m][j] = fmaf(a[m].x, b[j].x, acc[m][j]);
          acc[m][j] = fmaf(a[m].y, b[j].y, acc[m][j]);
          acc[m][j] = fmaf(a[m].z, b[j].z, acc[m][j]);
          acc[m][j] = fmaf(a[m].w, b[j].w, acc[m][j]);
        }
    }
    const long long row0 = cur.row0;
    cur.next(ns, tiles);
    buf = buf + 1 == kStages ? 0 : buf + 1;
    if (s != ns - 1) continue;
    // the item's gains: a thread stores 8 consecutive rows of a lane (two
    // 16-byte stores), a warp 32 rows of 8 lanes (8 runs of 128 bytes)
    if constexpr (P::kNorm) {
      sq[nrow] = norm;
      __syncthreads();
    }
    const long long row = row0 + kRowsPer * rg;
    const bool vec_out = (C & 3) == 0 && row + kRowsPer - 1 < C;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int l = lt * LT + tx + kGroups * j;
      if (l >= L) continue;
      float v[kRowsPer];
#pragma unroll
      for (int m = 0; m < kRowsPer; ++m) {
        if constexpr (P::kNorm)
          v[m] = __fsub_rn(acc[m][j], __fmul_rn(lam, sq[kRowsPer * rg + m]));
        else
          v[m] = acc[m][j];
      }
      float* o = out + (long long)l * C + row;
      if (vec_out) {
#pragma unroll
        for (int h = 0; h < kRowsPer; h += 4)
          *reinterpret_cast<float4*>(o + h) =
              make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
      } else {
#pragma unroll
        for (int m = 0; m < kRowsPer; ++m)
          if (row + m < C) o[m] = v[m];
      }
    }
  }
  cp_wait<0>();  // no copy in flight when the CTA exits
}

template <typename P, typename T, int NJ, bool kVec>
cudaError_t launch_tile(const T* x, const float* total, const float* state,
                        float lam, float* out, int L, long long C, int d,
                        cudaStream_t stream) {
  auto kern = lanes_tile_kernel<P, T, NJ, kVec>;
  constexpr int LT = kGroups * NJ;
  const int dc = coef_depth(LT, d);
  const size_t smem = smem_bytes<T, NJ>(LT, dc);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items =
      (C + kRows - 1) / kRows * ((L + LT - 1) / LT);
  const long long full = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(items < full ? items : full);
  kern<<<grid, kThreads, smem, stream>>>(x, total, state, 2.0f * lam, lam,
                                         out, L, C, d, dc);
  return cudaGetLastError();
}

template <typename P, typename T, bool kVec>
cudaError_t launch_lanes(const T* x, const float* total, const float* state,
                         float lam, float* out, int L, long long C, int d,
                         cudaStream_t stream) {
  const int lt = L < kMaxTile ? L : kMaxTile;
  switch ((lt + kGroups - 1) / kGroups) {
#define SKINNY_CASE(NJ)                                                    \
  case NJ:                                                                 \
    return launch_tile<P, T, NJ, kVec>(x, total, state, lam, out, L, C, d, \
                                       stream);
    SKINNY_CASE(1) SKINNY_CASE(2) SKINNY_CASE(3) SKINNY_CASE(4)
    SKINNY_CASE(5) SKINNY_CASE(6) SKINNY_CASE(7) SKINNY_CASE(8)
#undef SKINNY_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename P, typename T>
cudaError_t launch_dtype(const void* x, const float* total,
                         const float* state, float lam, void* out, int L,
                         long long C, int d, cudaStream_t stream) {
  const bool vec = d % Ring<T>::kChunk == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  return vec ? launch_lanes<P, T, true>(xt, total, state, lam, o, L, C, d,
                                        stream)
             : launch_lanes<P, T, false>(xt, total, state, lam, o, L, C, d,
                                         stream);
}

// The skinny product of x (C, d) f32 or bf16, shared by L >= 2 lanes of
// state (L, d) f32, into out (L, C) f32 under policy P; total and lam are
// GraphCut's (nullptr and 0 for WeightedCoverage).
template <typename P>
cudaError_t launch(const void* x, int x_is_bf16, const float* total,
                   const float* state, float lam, void* out, int L,
                   long long C, int d, cudaStream_t stream) {
  return x_is_bf16
             ? launch_dtype<P, __nv_bfloat16>(x, total, state, lam, out, L, C,
                                              d, stream)
             : launch_dtype<P, float>(x, total, state, lam, out, L, C, d,
                                      stream);
}

}  // namespace skinny
