// FacilityLocation marginal gains on Hopper (sm_90a): both kernels of
// src/repro/kernels/facility_marginals.py.
//
// facility_marginals (replaces facility_marginals, body _fm_kernel):
//
//     out[l, i] = sum_j max( max(<cand_i, ref_j>, 0) - state[l, j], 0 )
//
// rectified_residual_sum (replaces rectified_residual_sum, body _rrs_kernel):
//
//     out[l, i] = sum_j max( aux[i, j] - state[l, j], 0 )
//
// Both take an explicit lane axis L in place of the JAX engines' vmap: the
// candidate block is one (C, .) block shared by every lane (the filter,
// phase 1, the max-singleton and top-singleton calls) or one block per
// lane, (L, C, .) (the lazy chunks, the dense survivor phase).
//
// What bounds them on the H100:
//  * facility_marginals at the filter shape (L = 37, C = 1,048,576,
//    d = r = 256, f32) is a GEMM with an L-lane epilogue.  The vmap the JAX
//    engines put around it recomputes the product once per lane (37 x
//    2CRd ~ 5.1e12 FLOP); the similarity tile does not depend on the lane,
//    so here it is computed once per (row tile, column tile) and only the
//    epilogue runs per lane: 2CRd + 3LCR ~ 1.67e11 operations, 2.5 ms at
//    67 TFLOP/s of f32 FFMA, against 0.37 ms for its bytes.  Bound by
//    operations.
//  * rectified_residual_sum streams aux once: (2^20, 256) f32 is 1 GiB,
//    0.32 ms at 3.35 TB/s, and 3 operations per (lane, row, column).  At
//    one lane it is bound by bytes; with many lanes on a shared aux, by
//    operations: 37 lanes over the 98,560-row sample are 0.042 ms of f32
//    FLOP at the FMA rate against 0.030 ms of bytes, and its 3
//    instructions a term (sub, max, add) take twice that to issue.
//
// What the designs do about it:
//  * facility_marginals: the register-blocked SIMT tile of
//    marginals_tile.cuh (shared with exemplar_marginals.cu) with its
//    Facility rule: a CTA owns 128 candidate rows and up to 128 lanes,
//    computes each 128-column tile of rectified similarities once for all
//    of them (an 8 x 8 block of fmaf chains per thread, d staged 16 deep
//    and double-buffered), and sums the lanes' residuals in 4-lane x
//    4-row blocks that one thread owns, with no float atomics (a repeated
//    launch gives the same bits).
//  * rectified_residual_sum (namespace rwalk): a lane walk in the manner
//    of lane_rows.cuh, with the residual's own tiles.  Every output keeps
//    the first port's order: thread t of a warp forms one chain from 0.0f
//    over the column groups t, t + 32, ... ascending (a group is the
//    columns of one load: a float4 when r % 4 == 0, its residuals added
//    ((m0 + m1) + m2) + m3; else one column), and the warp adds the 32
//    chains in the xor butterfly's pairs (16, 8, 4, 2, 1).  A warp's tile
//    of R rows x J lanes runs them as one reduce-scatter (warp_scatter.cuh):
//    31 shuffles for 32 outputs, where the first port ran 5 for each of
//    its 8 lane slots a row, used or not.
//    - One lane (unbatched, per-lane aux, or fewer rows than a shared
//      tile; lane_kernel): a CTA a lane, a warp R = 16 rows (8 or 1 on
//      short inputs); a thread loads all its groups of 8 rows (at r = 256
//      16 float4s, 8 KiB a warp in flight) before it sums any of them, and
//      keeps its state groups in registers for the whole walk (up to 64
//      groups a row, r <= 256 in float4s; a wider state is read through
//      the read-only cache).  No shared memory: two CTAs an SM by
//      registers.
//    - Shared aux, L >= 2 (shared_kernel): a CTA stages a block of lanes'
//      states in shared memory once (all 37 at r = 256, 37 KiB).  A warp
//      loads a tile of 4 rows (16 in floats) into registers, 2 float4s a
//      row a thread, and scores it against every lane of the block, 8
//      lanes at a time (then 4, 2, 1): each aux value loaded serves every
//      lane, and each aux row is read from device memory once, where the
//      first port read it once per 8 lanes.
//    - Lane and row counts are template parameters (no lane test in the
//      term loop); a thread's column groups past r are zeros in registers,
//      which add +0 to a chain and leave its bits as they are.  No row past
//      C is read: the last tile of a row range is moved back to end at row
//      C - 1 and stores only its own rows.  Each output is written once by
//      one thread, with no atomics, so a repeated launch gives the same
//      bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "marginals_tile.cuh"
#include "warp_scatter.cuh"

namespace {

// ------------------------------------------------------------- residual
namespace rwalk {

using warp_scatter::Scatter;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLaneRows = 16;   // rows of a one-lane warp tile
constexpr int kRegSteps = 2;    // column groups a thread holds in registers
// shared memory a CTA may stage and still share its SM with a second CTA
constexpr size_t kTwoPerSm = 113 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// kVec columns a load: float4 for r % 4 == 0, else float
template <int kVec>
using Vec = typename std::conditional<kVec == 4, float4, float>::type;

// rows of a shared-aux warp tile: 16 floats of aux a column group
template <int kVec>
constexpr int kSharedRows = 16 / kVec;

// max(a - s, 0), summed over the columns of one load in column order
__device__ __forceinline__ float residual(float a, float s) {
  return fmaxf(a - s, 0.0f);
}
__device__ __forceinline__ float residual(float4 a, float4 s) {
  return ((fmaxf(a.x - s.x, 0.0f) + fmaxf(a.y - s.y, 0.0f)) +
          fmaxf(a.z - s.z, 0.0f)) + fmaxf(a.w - s.w, 0.0f);
}

// The warp's chains acc[j * R + row] of R rows x J lanes, summed by one
// reduce-scatter; out[j * C + row] gets output (row, j) for rows >= first
// (the rows before it belong to the tile before, which this one overlaps
// at the end of the rows).
template <int R, int J>
__device__ __forceinline__ void store(float* acc, int first, int lane,
                                      float* __restrict__ ob, long long C) {
  constexpr int N = R * J;
  const float v = Scatter<N, 16>::run(acc, lane);
  constexpr int kCopies = 32 / N;  // threads that end with the same output
  if ((lane & (kCopies - 1)) == 0) {
    const int o = lane / kCopies;
    const int j = o / R, r = o % R;
    if (r >= first) ob[j * C + r] = v;
  }
}

// One lane's warp tile of R rows of aux (groups ab, ab + rv, ...).  With
// kG > 0 (rv <= 32 kG) the thread's kG state groups are in registers (s)
// and it loads all its kG groups of 64 / (kVec kG) rows before it sums
// any of them; else it walks its groups one at a time and reads the
// state through the read-only cache (sl).
template <int R, int kVec, int kG>
__device__ __forceinline__ void lane_tile(
    const Vec<kVec>* __restrict__ ab, int first,
    const Vec<kVec>* __restrict__ sl, const Vec<kVec> (&s)[kG > 0 ? kG : 1],
    int rv, int lane, float* __restrict__ ob, long long C) {
  using V = Vec<kVec>;
  constexpr int kHeld = 64 / (kVec * (kG > 0 ? kG : 1));
  constexpr int Rb = R < kHeld ? R : kHeld;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int rb = 0; rb < R; rb += Rb) {
    const V* a0 = ab + (long long)rb * rv;
    if constexpr (kG > 0) {
      V a[kG][Rb];
#pragma unroll
      for (int k = 0; k < kG; ++k)
#pragma unroll
        for (int r = 0; r < Rb; ++r)
          a[k][r] = lane + 32 * k < rv
              ? __ldg(a0 + (long long)r * rv + lane + 32 * k) : V{};
#pragma unroll
      for (int k = 0; k < kG; ++k)
#pragma unroll
        for (int r = 0; r < Rb; ++r) acc[rb + r] += residual(a[k][r], s[k]);
    } else {
#pragma unroll 1
      for (int c = lane; c < rv; c += 32) {
        V a[Rb];
#pragma unroll
        for (int r = 0; r < Rb; ++r) a[r] = __ldg(a0 + (long long)r * rv + c);
        const V sv = __ldg(sl + c);
#pragma unroll
        for (int r = 0; r < Rb; ++r) acc[rb + r] += residual(a[r], sv);
      }
    }
  }
  store<R, 1>(acc, first, lane, ob, C);
}

// One lane's rows (C >= R): lane blockIdx.x's aux rows start at aux +
// blockIdx.x * lane_stride floats (per-lane aux: C * r; shared aux: 0),
// its state at state + blockIdx.x * r.  CTA (blockIdx.x, blockIdx.y)'s
// warps take the lane's R-row tiles blockIdx.y * kWarps + warp, +
// gridDim.y * kWarps, ...
template <int kVec, int R, int kG>
__global__ void __launch_bounds__(kThreads, 2)
lane_kernel(const float* __restrict__ aux, long long lane_stride,
            const float* __restrict__ state, float* __restrict__ out,
            long long C, int r) {
  using V = Vec<kVec>;
  const int l = blockIdx.x, rv = r / kVec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const V* al = reinterpret_cast<const V*>(aux + l * lane_stride);
  const V* sl = reinterpret_cast<const V*>(state + (long long)l * r);
  float* ol = out + (long long)l * C;
  V s[kG > 0 ? kG : 1];
#pragma unroll
  for (int k = 0; k < kG; ++k)
    s[k] = lane + 32 * k < rv ? __ldg(sl + lane + 32 * k) : V{};
  const long long n_row_tiles = (C + R - 1) / R;
  for (long long b = (long long)blockIdx.y * kWarps + warp; b < n_row_tiles;
       b += (long long)gridDim.y * kWarps) {
    const long long row0 = b * R;
    const long long start = row0 < C - R ? row0 : C - R;
    lane_tile<R, kVec, kG>(al + start * rv, (int)(row0 - start), sl, s, rv,
                           lane, ol + start, C);
  }
}

// The R rows' outputs of J lanes (states sp, sp + rv, ... in shared
// memory): on aux groups held in registers (a, kG > 0), or loaded a group
// at a time (rows ab, ab + rv, ...).
template <int R, int J, int kVec, int kG>
__device__ __forceinline__ void lanes_tile(
    const Vec<kVec> (&a)[kG > 0 ? kG : 1][R], const Vec<kVec>* __restrict__ ab,
    const Vec<kVec>* sp, int rv, int lane, int first, float* __restrict__ ob,
    long long C) {
  using V = Vec<kVec>;
  float acc[R * J];  // acc[j * R + row]
#pragma unroll
  for (int i = 0; i < R * J; ++i) acc[i] = 0.0f;
  if constexpr (kG > 0) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        const int c = lane + 32 * k;
        const V s = c < rv ? sp[j * rv + c] : V{};
#pragma unroll
        for (int r = 0; r < R; ++r) acc[j * R + r] += residual(a[k][r], s);
      }
  } else {
#pragma unroll 1
    for (int c = lane; c < rv; c += 32) {
      V av[R];
#pragma unroll
      for (int r = 0; r < R; ++r) av[r] = __ldg(ab + (long long)r * rv + c);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const V s = sp[j * rv + c];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[j * R + r] += residual(av[r], s);
      }
    }
  }
  store<R, J>(acc, first, lane, ob, C);
}

// Shared aux (C, r), L >= 2, C >= R: CTA (blockIdx.x, blockIdx.y) stages
// lane block blockIdx.x's states in shared memory; its warps take R-row
// tiles blockIdx.y * kWarps + warp, + gridDim.y * kWarps, ..., and score
// each against every lane of the block, 32 / R lanes at a time (then 4,
// 2 and 1), with the tile's aux in registers when kG > 0.
template <int kVec, int kG>
__global__ void __launch_bounds__(kThreads, 2)
shared_kernel(const float* __restrict__ aux, const float* __restrict__ state,
              float* __restrict__ out, int L, long long C, int r,
              int lanes_per_cta) {
  using V = Vec<kVec>;
  constexpr int R = kSharedRows<kVec>;
  constexpr int kJ = 32 / R;  // lanes of a full chunk
  extern __shared__ float4 smem[];
  const int l0 = blockIdx.x * lanes_per_cta;
  const int nl = min(lanes_per_cta, L - l0);
  const int rv = r / kVec;
  V* sp = reinterpret_cast<V*>(smem);
  const V* st = reinterpret_cast<const V*>(state + (long long)l0 * r);
  for (int t = threadIdx.x; t < nl * rv; t += kThreads) sp[t] = __ldg(st + t);
  __syncthreads();

  const V* av = reinterpret_cast<const V*>(aux);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_row_tiles = (C + R - 1) / R;
  for (long long b = (long long)blockIdx.y * kWarps + warp; b < n_row_tiles;
       b += (long long)gridDim.y * kWarps) {
    const long long row0 = b * R;
    const long long start = row0 < C - R ? row0 : C - R;
    const int first = (int)(row0 - start);
    const V* ab = av + start * rv;
    V a[kG > 0 ? kG : 1][R];
    if constexpr (kG > 0) {
#pragma unroll
      for (int k = 0; k < kG; ++k)
#pragma unroll
        for (int i = 0; i < R; ++i)
          a[k][i] = lane + 32 * k < rv
              ? __ldg(ab + (long long)i * rv + lane + 32 * k) : V{};
    }
    float* ob = out + (long long)l0 * C + start;
    int lo = 0;
    for (; lo + kJ <= nl; lo += kJ)
      lanes_tile<R, kJ, kVec, kG>(a, ab, sp + lo * rv, rv, lane, first,
                                  ob + lo * C, C);
    if constexpr (kJ > 4)
      if ((nl - lo) & 4) {
        lanes_tile<R, 4, kVec, kG>(a, ab, sp + lo * rv, rv, lane, first,
                                   ob + lo * C, C);
        lo += 4;
      }
    if constexpr (kJ > 2)
      if ((nl - lo) & 2) {
        lanes_tile<R, 2, kVec, kG>(a, ab, sp + lo * rv, rv, lane, first,
                                   ob + lo * C, C);
        lo += 2;
      }
    if constexpr (kJ > 1)
      if ((nl - lo) & 1)
        lanes_tile<R, 1, kVec, kG>(a, ab, sp + lo * rv, rv, lane, first,
                                   ob + lo * C, C);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kVec, int R>
cudaError_t launch_lane(dim3 grid, int kg, const float* aux,
                        long long lane_stride, const float* state, float* out,
                        long long C, int r, cudaStream_t stream) {
  if (kg)
    lane_kernel<kVec, R, kRegSteps><<<grid, kThreads, 0, stream>>>(
        aux, lane_stride, state, out, C, r);
  else
    lane_kernel<kVec, R, 0><<<grid, kThreads, 0, stream>>>(
        aux, lane_stride, state, out, C, r);
  return cudaGetLastError();
}

template <int kVec, int kG>
cudaError_t launch_shared(dim3 grid, size_t smem, const float* aux,
                          const float* state, float* out, int L, long long C,
                          int r, int lpc, cudaStream_t stream) {
  cudaError_t e = allow_smem(shared_kernel<kVec, kG>, smem);
  if (e != cudaSuccess) return e;
  shared_kernel<kVec, kG><<<grid, kThreads, smem, stream>>>(
      aux, state, out, L, C, r, lpc);
  return cudaGetLastError();
}

// Launch the walk on aux (C, r) shared or (L, C, r) per lane; L, C, r > 0.
template <int kVec>
cudaError_t launch(const float* aux, int aux_per_lane, const float* state,
                   float* out, int L, long long C, int r,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int rv = r / kVec;
  const int kg = rv <= 32 * kRegSteps;  // state or aux groups in registers
  auto smem_of = [&](int lanes) { return (size_t)lanes * r * sizeof(float); };
  constexpr int kRows = kSharedRows<kVec>;

  if (aux_per_lane || L == 1 || C < kRows || smem_of(1) > kMaxSmem) {
    // one lane a CTA (a shared aux shorter than a warp tile, or whose state
    // rows do not fit in shared memory, is read by every lane); R rows a
    // warp tile, R <= C: kLaneRows where every warp of a full card gets a
    // tile, else 8 (more warps on fewer rows), or 1.  The same policy as
    // lane_rows::launch's one-lane route (lane_rows.cuh): change the two
    // together.
    const int resident = 2 * sms;
    const long long big = (long long)L * ((C + kLaneRows - 1) / kLaneRows);
    const int R = C >= kLaneRows && big >= (long long)resident * kWarps
        ? kLaneRows : C >= 8 ? 8 : 1;
    const long long per_lane_ctas = ((C + R - 1) / R + kWarps - 1) / kWarps;
    const long long fit = resident / L > 1 ? resident / L : 1;
    const dim3 grid(L, (unsigned)(per_lane_ctas < fit ? per_lane_ctas : fit));
    const long long stride = aux_per_lane ? C * r : 0;
    if (R == kLaneRows)
      return launch_lane<kVec, kLaneRows>(grid, kg, aux, stride, state, out,
                                          C, r, stream);
    if (R == 8)
      return launch_lane<kVec, 8>(grid, kg, aux, stride, state, out, C, r,
                                  stream);
    return launch_lane<kVec, 1>(grid, kg, aux, stride, state, out, C, r,
                                stream);
  }

  // lanes per CTA: as many as fit beside a second CTA on the SM (or alone
  // on it when one lane needs more), but at least 8 a block and enough
  // blocks to fill the card when the rows give few CTAs; spread evenly
  const size_t budget = smem_of(1) <= kTwoPerSm ? kTwoPerSm : kMaxSmem;
  int fit = (int)(budget / (r * sizeof(float)));
  if (fit > L) fit = L;
  const long long ctas = ((C + kRows - 1) / kRows + kWarps - 1) / kWarps;
  const long long want = (2 * sms + ctas - 1) / ctas;
  const int most = (L + 7) / 8;
  int blocks = (L + fit - 1) / fit;
  const int spread = (int)(want < most ? want : most);
  if (spread > blocks) blocks = spread;
  const int lpc = (L + blocks - 1) / blocks;
  blocks = (L + lpc - 1) / lpc;
  const size_t smem = smem_of(lpc);
  const int resident = (smem <= kTwoPerSm ? 2 : 1) * sms;
  const long long per_block = resident / blocks > 1 ? resident / blocks : 1;
  const dim3 grid(blocks, (unsigned)(ctas < per_block ? ctas : per_block));
  if (kg)
    return launch_shared<kVec, kRegSteps>(grid, smem, aux, state, out, L, C,
                                          r, lpc, stream);
  return launch_shared<kVec, 0>(grid, smem, aux, state, out, L, C, r, lpc,
                                stream);
}

}  // namespace rwalk

}  // namespace

extern "C" int facility_marginals_launch(const void* cand, int cand_is_bf16,
                                         int cand_per_lane, const void* ref,
                                         const void* state, void* out, int L,
                                         long long C, int r, int d,
                                         void* stream) {
  return (int)mtile::launch(cand, cand_is_bf16, cand_per_lane, ref,
                                        reftile::Facility{nullptr}, state, out,
                                        L, C, r, d,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int rectified_residual_sum_launch(const void* aux, int aux_per_lane,
                                             const void* state, void* out,
                                             int L, long long C, int r,
                                             void* stream) {
  if (L <= 0 || C <= 0) return (int)cudaSuccess;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(aux);
  const float* s = static_cast<const float*>(state);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // torch allocations are 16-byte aligned, and with r % 4 == 0 so is
  // every row
  return (int)(r % 4 == 0
      ? rwalk::launch<4>(a, aux_per_lane, s, o, L, C, r, st)
      : rwalk::launch<1>(a, aux_per_lane, s, o, L, C, r, st));
}
