// The warp sum of N outputs at once, in the pairs of the xor butterfly, for
// every walk that batches a row loop's reductions (lane_rows.cuh,
// reference_tile.cuh, feature_sweep.cuh).
//
// The row loops reduce one value a warp with the butterfly
//
//     v += __shfl_xor_sync(full, v, o)   for o = 16, 8, 4, 2, 1,
//
// and both partners of a pair add the same two values, so every lane ends
// with the same bits.  A reduce-scatter adds N outputs in those same pairs:
// while a thread holds more than one output it keeps the half that bit O of
// its lane selects (the upper half when the bit is set) and adds its
// partner's copy of that half; with one output left it runs the rest of the
// butterfly.  Thread t ends with output t / (32 / N), bit for bit the
// butterfly of that output (each group of 32 / N lanes holds the same
// bits), after N - 1 + 5 - log2(N) shuffles in place of 5 N.
#pragma once

#include <cuda_runtime.h>

namespace warp_scatter {

constexpr unsigned kFull = 0xffffffffu;

// The sum of v[0..N) over the warp, scattered (N a power of two <= 32,
// O = 16 at the call); v is clobbered.
template <int N, int O>
struct Scatter {
  static __device__ __forceinline__ float run(float* v, int lane) {
    if constexpr (N == 1) {
      float s = v[0];
#pragma unroll
      for (int o = O; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      return s;
    } else {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      return Scatter<H, O / 2>::run(v, lane);
    }
  }
};

}  // namespace warp_scatter
