// Matched scoring for Hopper (sm_90a): scores[b, g] = sum_k (rate[b, k] -
// mean_k rate[b, k]) * table[g, k], the epilogue of the "matched" estimator
// (models/xylo/pipeline.Demo.doa_scores; JAX pipeline.py:396-463), or with
// center = 0 the plain products sum_k rate[b, k] * table[g, k].
//
// Replaces no TPU kernel: the JAX package computes it through XLA, and the
// port's plain version is one torch.matmul, whose cuBLAS kernel, and so its
// rounding, follow the number of frames in the call (below 24 frames at the
// flagship's 449 x 449 table a frame's scores moved with the batch).  Here a
// frame's scores are a function of that frame alone, every sum in one fixed
// order.  The mean: lane j of a warp adds the entries k = j, j + 32, ... in
// that order, then the 32 partial sums meet in a butterfly of fixed pairs,
// and the sum is divided by K.  A score: the lanes of one warp run over k the
// same way (coalesced reads of the table row), one FMA a term, and the same
// butterfly.
//
// A block of threads takes a tile of FT frames and 32 table rows: the
// frames' rates sit in shared memory (each block computes their means, in
// the order above), and each warp's lanes load a table element once and
// apply it to all FT frames, so the table is read once per frame tile, not
// once per frame.  At the flagship (96 frames, 449 x 449) that is 12 x 15 =
// 180 blocks.  Which frames share a tile changes no score: a score's terms
// and their order depend on its frame and row alone.
//
// What bounds it on the card: B * G * K FMAs (38.7 MFLOP at the flagship:
// 0.0006 ms at 67 TFLOP/s) and the table's bytes (0.8 MB, read from L2 by
// every frame tile after the first); at B = 96 a launch is a few
// microseconds of latency, not throughput.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;            // table rows a block
constexpr int RW = ROWS / WARPS;    // table rows a warp
constexpr int K_MAX = 12000;        // entries of a rate row
constexpr int SMEM_MAX = 232448;    // shared memory a block can use

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int FT>
__global__ void __launch_bounds__(THREADS) matched_kernel(const float* __restrict__ rate,
                                                          const float* __restrict__ table,
                                                          float* __restrict__ scores, int B, int K, int G,
                                                          int center) {
  extern __shared__ float r[];  // [FT][K]
  __shared__ float mean[FT];
  const int b0 = blockIdx.x * FT, g0 = blockIdx.y * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nf = min(FT, B - b0);
  const float* rows = rate + (long long)b0 * K;
  for (int e = threadIdx.x; e < nf * K; e += THREADS) r[e] = rows[e];
  __syncthreads();
  if (center) {
    for (int f = warp; f < nf; f += WARPS) {
      float acc = 0.f;
      for (int k = lane; k < K; k += 32) acc += r[f * K + k];
      acc = warp_sum(acc);
      if (lane == 0) mean[f] = acc / (float)K;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nf * K; e += THREADS) r[e] -= mean[e / K];
    __syncthreads();
  }

  const int g1 = g0 + warp * RW;  // this warp's first row
  float acc[RW][FT];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int f = 0; f < FT; ++f) acc[j][f] = 0.f;
#pragma unroll 2
  for (int k = lane; k < K; k += 32) {
    float t[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) t[j] = g1 + j < G ? __ldg(table + (long long)(g1 + j) * K + k) : 0.f;
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float v = f < nf ? r[f * K + k] : 0.f;
#pragma unroll
      for (int j = 0; j < RW; ++j) acc[j][f] = fmaf(v, t[j], acc[j][f]);
    }
  }
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float s = warp_sum(acc[j][f]);
      if (lane == 0 && f < nf && g1 + j < G) scores[(long long)(b0 + f) * G + g1 + j] = s;
    }
}

template <int FT>
int launch(const float* rate, const float* table, float* scores, int B, int K, int G, int center,
           cudaStream_t st) {
  static unsigned long long opted = 0;  // per instantiation, a bit a device: the opt-in above 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(opted >> dev & 1)) {
    err = cudaFuncSetAttribute(matched_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(FT * K_MAX * sizeof(float)) < SMEM_MAX - 1024
                                   ? (int)(FT * K_MAX * sizeof(float)) : SMEM_MAX - 1024);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted |= 1ULL << dev;
  }
  const dim3 grid((B + FT - 1) / FT, (G + ROWS - 1) / ROWS);
  matched_kernel<FT><<<grid, THREADS, (size_t)FT * K * sizeof(float), st>>>(rate, table, scores, B, K, G, center);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hm_matched_max_k() { return K_MAX; }

// rate (B, K), table (G, K), scores (B, G); all float32, contiguous; center
// 1 centres each rate row on its mean first.  Eight frames a block where
// their rows fit in shared memory (K <= 7168), else four.
int hm_matched(const float* rate, const float* table, float* scores, int B, int K, int G, int center,
               void* stream) {
  if (B < 1 || K < 1 || K > K_MAX || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return K <= 7168 ? launch<8>(rate, table, scores, B, K, G, center, st)
                   : launch<4>(rate, table, scores, B, K, G, center, st);
}

}  // extern "C"
