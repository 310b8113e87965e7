// Matched scoring for Hopper (sm_90a): scores[b, g] = sum_k (rate[b, k] -
// mean_k rate[b, k]) * table[g, k], the epilogue of the "matched" estimator
// (models/xylo/pipeline.Demo.doa_scores; JAX pipeline.py:396-463).
//
// Replaces no TPU kernel: the JAX package computes it through XLA, and the
// port's plain version is one torch.matmul, whose cuBLAS kernel, and so its
// rounding, follow the number of frames in the call (below 24 frames at the
// flagship's 449 x 449 table a frame's scores moved with the batch).  Here a
// frame's scores are a function of that frame alone: one block a frame,
// every sum in one fixed order.  The mean: lane j of the first warp adds the
// entries k = j, j + 32, ... in that order, then the 32 partial sums meet in
// a butterfly of fixed pairs, and the sum is divided by K.  A score: one warp
// a row g of the table, its lanes over k the same way (coalesced reads of the
// row), the same butterfly.
//
// What bounds it on the card: the table's bytes (0.8 MB at the flagship,
// read from L2 by every frame's block after the first) and B * G * K FMAs;
// at B = 96 it is launch-bound.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int K_MAX = 12000;  // entries of a rate row held in shared memory (under 48 KB)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) matched_kernel(const float* __restrict__ rate,
                                                          const float* __restrict__ table,
                                                          float* __restrict__ scores, int K, int G) {
  extern __shared__ float r[];
  __shared__ float mean;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = rate + (long long)b * K;
  for (int k = threadIdx.x; k < K; k += THREADS) r[k] = row[k];
  __syncthreads();
  if (warp == 0) {
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc += r[k];
    acc = warp_sum(acc);
    if (lane == 0) mean = acc / (float)K;
  }
  __syncthreads();
  const float m = mean;
  for (int k = threadIdx.x; k < K; k += THREADS) r[k] -= m;
  __syncthreads();
  for (int g = warp; g < G; g += THREADS / 32) {
    const float* t = table + (long long)g * K;
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc = fmaf(r[k], __ldg(t + k), acc);
    acc = warp_sum(acc);
    if (lane == 0) scores[(long long)b * G + g] = acc;
  }
}

}  // namespace

extern "C" {

int hm_matched_max_k() { return K_MAX; }

// rate (B, K), table (G, K), scores (B, G); all float32, contiguous.
int hm_matched(const float* rate, const float* table, float* scores, int B, int K, int G, void* stream) {
  if (B < 1 || K < 1 || K > K_MAX || G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * sizeof(float);
  matched_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(rate, table, scores, K, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
