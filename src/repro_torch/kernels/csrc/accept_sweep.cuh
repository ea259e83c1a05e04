// The shared ThresholdGreedy accept sweep for the fused chunk-accept
// kernels (the Hopper counterpart of run_sweep in
// src/repro/kernels/_accept_common.py), in both of its modes.
//
// One CTA sweeps one lane's (B, d) tile in stream order.  Row i is scored
// against the state after every earlier accept, and it is accepted iff
//
//     eligible[i] && gain_i >= tau && accepts_so_far < budget
//
// (the cardinality mode, kCost = false), or, in the knapsack cost mode
// (kCost = true, a (B,) row-cost vector c and a remaining budget),
//
//     eligible[i] && gain_i >= tau * c_i && accepts_so_far < budget
//                 && spent + c_i <= cost_budget,
//
// with spent the f32 sum of the accepted costs, added in row order; each
// product and sum is rounded on its own (__fmul_rn, __fadd_rn), as the JAX
// carry rounds it.  The mode is a template parameter, so the cardinality
// instantiation is the loop without any cost code.
//
// The order is the semantics, so the rows form a chain of B dependent block
// reductions; that chain, not the bytes, is what bounds a sweep.  The
// design keeps each link short:
//  * every thread owns a fixed slice of the state in registers (the Step
//    holds it), so an accept is a thread-local update with no barrier;
//  * a row costs one block reduction: warp shuffles, then one partial per
//    warp in shared memory, read by every thread in the same order, so
//    every thread holds the bit-identical gain and takes the same decision;
//  * the shared partials are double-buffered on the row's parity, so each
//    row needs a single __syncthreads: a thread can only overwrite slot
//    (i & 1) for row i + 2 after the barrier of row i + 1, which every
//    thread reaches only after it has read row i's partials.
//
// A Step supplies the oracle's gain and update on its register slice:
//     float partial(int i)  this thread's share of row i's gain, against
//                           the current state
//     void  accept()        apply the row just scored to the state
// The feature sweeps' row loop and wide instance (feature_sweep.cuh) and
// the wide instance of facility_accept.cu and exemplar_accept.cu run on it
// with their own Steps; their walks batch this loop's reduction tree over
// a window of rows (walk_kernel in feature_sweep.cuh and
// reference_tile.cuh) and keep its decisions and bits.
#pragma once

#include <cuda_runtime.h>

template <int kThreads, bool kCost, class Step>
__device__ __forceinline__ void run_sweep(Step& step, int B,
                                          const unsigned char* __restrict__ eligible,
                                          float tau, int budget,
                                          const float* __restrict__ cost,
                                          float cost_budget,
                                          unsigned char* __restrict__ mask_out,
                                          float* __restrict__ gains_out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float partials[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_acc = 0;
  float spent = 0.0f;
  for (int i = 0; i < B; ++i) {
    float p = step.partial(i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) partials[i & 1][warp] = p;
    __syncthreads();
    float gain = partials[i & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) gain += partials[i & 1][w];
    bool acc;
    if constexpr (kCost) {
      const float c = cost[i];
      acc = eligible[i] && gain >= __fmul_rn(tau, c) && n_acc < budget &&
            __fadd_rn(spent, c) <= cost_budget;
      if (acc) spent = __fadd_rn(spent, c);
    } else {
      acc = eligible[i] && gain >= tau && n_acc < budget;
    }
    if (acc) {
      step.accept();
      ++n_acc;
    }
    if (threadIdx.x == 0) {
      mask_out[i] = acc ? 1 : 0;
      gains_out[i] = gain;
    }
  }
}
