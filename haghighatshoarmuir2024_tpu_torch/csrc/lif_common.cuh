// What the integer-LIF kernels of csrc/lif.cu (K3/K4, from the two RZCC
// polarity masks) and csrc/lif_raster.cu (K5/K6, from one int8 spike raster)
// share: the dynamics, the two launch layouts, the packs' tile.
//
// Per step and neuron, all state int32:
//
//   K3/K4: cur = [kp & ~kn | kn] @ w_in     (-1 wins on collision)
//   K5/K6: cur = v[t, b, :] @ w_in
//   cur += rec * sum_n spk_prev[b, n]
//   isyn = isyn - (isyn >> dash_syn) + cur    (arithmetic shift; clip to int16
//   vmem = vmem - (vmem >> dash_mem) + isyn    range unless proven dead)
//   spk  = vmem >= thr;  vmem -= spk * thr;  count += spk
//
// which is models/xylo/sim._sim_hidden with decay_first / subtract.  The T
// steps run to T and stop: there is no time padding, so nothing past T needs
// freezing (the Pallas kernels' has_tail masks).
//
// One thread per (b, n) chain; the T steps of a chain are sequential.  Two
// layouts, by the uniform recurrence rec:
//
//   rec == 0  the B*N chains are independent.  K3/K4: blocks of NT = 64
//             neurons of one batch row, each thread's weight column in
//             shared memory, where only it reads it.  K5/K6: blocks of one
//             warp, 32 neurons of one batch row.
//   rec != 0  the chains of a row are coupled through sum_n spk_prev.  One
//             block holds all N <= 1024 neurons of a row, and the sum is one
//             __syncthreads_count per step.  The weights are read through the
//             read-only cache: at N = 1024 they would not fit in shared
//             memory.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT_MAX = 1024;  // neurons per block (one whole row) when rec != 0
constexpr int STATE_MIN = -(1 << 15);
constexpr int STATE_MAX = (1 << 15) - 1;
constexpr int PACK_T = 32;  // both packs: steps per tile, one a lane; Tp is a multiple
constexpr int PACK_B = 8;   // both packs: batch rows per tile, one a warp

// One step of one chain: decay, input, clip, threshold and subtract.
// Returns whether the neuron fired.  Shared by all four kernels.
template <bool CLIP>
__device__ __forceinline__ bool lif_step(int& isyn, int& vmem, int cur, int ds, int dm, int th,
                                         bool live) {
  isyn = isyn - (isyn >> ds) + cur;
  if (CLIP) isyn = min(max(isyn, STATE_MIN), STATE_MAX);
  vmem = vmem - (vmem >> dm) + isyn;
  if (CLIP) vmem = min(max(vmem, STATE_MIN), STATE_MAX);
  const bool fired = live && vmem >= th;
  if (fired) vmem -= th;
  return fired;
}

}  // namespace
