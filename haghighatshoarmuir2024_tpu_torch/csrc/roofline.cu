// Roofline probes for Hopper (sm_90a): P1, P2 and P3.
//
// Replace the Pallas probes of the TPU's roofline harness
// experiments/vpu_roofline.py:
//   P1 probe_p1 <- _peak_kernel (:77): the integer LIF op mix (two arithmetic
//                  shifts, subtracts and adds, a compare, a conditional
//                  subtract, a count) on register-resident int32 chains with
//                  no memory traffic in the loop.  ILP independent chains per
//                  thread (a template parameter) and the launch shape are the
//                  sweep's knobs: the best reading is the integer ceiling of
//                  the card for this mix, the reading at K3's launch shape
//                  says what K3's occupancy allows.
//   P2 probe_p2 <- _shiftmax_peak_kernel (:163): dilated doubling max-down
//                  then min-up chains over a (TBe, 32) float32 tile, the op
//                  mix of the suppression kernels.  Each block loads its own
//                  tile once and keeps it in registers; every chain step
//                  publishes the tile to shared memory and reads the shifted
//                  neighbour back.  It executes one shifted shared-memory
//                  read and one max (or min) per chain step: its rate is
//                  the compares per second this formulation reaches.
//   P3 probe_p3 <- _lif_kernel_bipolar_k (:226): K3 on the flagship fast path
//                  (no recurrence, no clip, decay first, subtract).  Per
//                  chunk of staged steps a block first computes the dense
//                  int32 input currents of its 64 neurons into shared memory
//                  (the TPU kernel's jnp.dot into inp_ref, :244-248; here
//                  __dp4a over the packed int8 inputs and weights), then each
//                  thread runs K steps per unrolled iteration.  Its counts
//                  equal K3's bit for bit.
//
// What bounds them: P1 the integer pipes (by design), P2 shared memory and
// its barriers (by design), P3 the dependent chain of each neuron, as K3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ P1
template <int ILP>
__global__ void probe_p1_kernel(const int* __restrict__ x, int* __restrict__ out, long long n,
                                int iters) {
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int xv[ILP], isyn[ILP], vmem[ILP], cnt[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const long long e = g + j * nthreads;
    xv[j] = e < n ? x[e] : 0;
    isyn[j] = xv[j];
    vmem[j] = xv[j] + 1;
    cnt[j] = 0;
  }
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      isyn[j] = isyn[j] - (isyn[j] >> 2) + xv[j];
      vmem[j] = vmem[j] - (vmem[j] >> 2) + isyn[j];
      const bool fired = vmem[j] >= 127;
      vmem[j] = fired ? vmem[j] - 127 : vmem[j];
      cnt[j] += fired ? 1 : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const long long e = g + j * nthreads;
    if (e < n) out[e] = isyn[j] + vmem[j] + cnt[j];
  }
}

template <int ILP>
int launch_p1(const int* x, int* out, long long n, int iters, int blocks, int threads,
              cudaStream_t st) {
  probe_p1_kernel<ILP><<<blocks, threads, 0, st>>>(x, out, n, iters);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ P2
constexpr int P2_RB = 32;  // rows per tile: threadIdx.x, as K1/K2/K7
constexpr int P2_TY = 8;   // warps per block, strided over time: threadIdx.y
constexpr float P2_LOW = -3.0e38f, P2_HIGH = 3.0e38f;  // the Pallas probe's fills

// The tile of K2/K7's first design at the flagship: 256 samples plus the
// halo _margin(11) = 48 on each side.  PER of them per thread in registers.
constexpr int P2_PER = 44;
constexpr int P2_TBE = P2_PER * P2_TY;

// The shared tile has w rows of padding on each side, holding the fills, so
// a shifted read needs no bounds test: the front pad serves the max-down
// chains, the back pad the min-up chains (a step is at most (w + 1) / 2).
__global__ void probe_p2_kernel(const float* __restrict__ x, float* __restrict__ out, int w,
                                int rep) {
  extern __shared__ float buf[];  // (w + TBe + w, P2_RB)
  constexpr int TBe = P2_TBE, PER = P2_PER;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t base = (size_t)blockIdx.x * TBe * P2_RB;
  float* tile = buf + w * P2_RB;
  for (int t = ty; t < w; t += P2_TY) {
    buf[t * P2_RB + tx] = P2_LOW;
    tile[(TBe + t) * P2_RB + tx] = P2_HIGH;
  }
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = x[base + (size_t)(ty + i * P2_TY) * P2_RB + tx];
  for (int r = 0; r < rep; ++r) {
    for (int up = 0; up < 2; ++up) {
      for (int k = 1; k < w + 1;) {
        const int step = min(k, w + 1 - k);
#pragma unroll
        for (int i = 0; i < PER; ++i) tile[(ty + i * P2_TY) * P2_RB + tx] = v[i];
        __syncthreads();
        if (up) {
#pragma unroll
          for (int i = 0; i < PER; ++i)
            v[i] = fminf(v[i], tile[(ty + i * P2_TY + step) * P2_RB + tx]);
        } else {
#pragma unroll
          for (int i = 0; i < PER; ++i)
            v[i] = fmaxf(v[i], tile[(ty + i * P2_TY - step) * P2_RB + tx]);
        }
        __syncthreads();
        k += step;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) out[base + (size_t)(ty + i * P2_TY) * P2_RB + tx] = v[i];
}

int launch_p2(const float* x, float* out, int nb, int w, int rep, cudaStream_t st) {
  const size_t smem = (size_t)(P2_TBE + 2 * w) * P2_RB * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(probe_p2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_p2_kernel<<<nb, dim3(P2_RB, P2_TY), smem, st>>>(x, out, w, rep);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ P3
constexpr int P3_NT = 64;    // neurons per block (one batch row), as K3
constexpr int P3_TC = 128;   // steps staged per chunk
constexpr int P3_NW = 8;     // 32-bit words of the packed (2C) int8 input: 2C <= 32
constexpr int P3_MAX_C = 2 * P3_NW;  // channels per polarity

// csrc/lif_common.cuh's lif_step<false>: decay first, input, threshold, subtract.
__device__ __forceinline__ bool lif_step(int& isyn, int& vmem, int cur, int ds, int dm, int th,
                                         bool live) {
  isyn = isyn - (isyn >> ds) + cur;
  vmem = vmem - (vmem >> dm) + isyn;
  const bool fired = live && vmem >= th;
  if (fired) vmem -= th;
  return fired;
}

template <int K>
__global__ void probe_p3_kernel(const uint8_t* __restrict__ kp, const uint8_t* __restrict__ kn,
                                const int* __restrict__ w_in,  // (2C, N), int8 values
                                const int* __restrict__ dash_syn, const int* __restrict__ dash_mem,
                                const int* __restrict__ thr, int* __restrict__ counts, int T,
                                int B, int C, int N) {
  __shared__ int s_in[P3_TC * P3_NW];   // a chunk's [kp & ~kn, kn] as packed int8
  __shared__ int s_cur[P3_TC * P3_NT];  // the chunk's dense currents, (step, neuron)
  const int tx = threadIdx.x;
  const int b = blockIdx.y;
  const int n = blockIdx.x * P3_NT + tx;
  const bool live = n < N;
  const int nw = (2 * C + 3) / 4;

  int wpk[P3_NW];  // this neuron's 2C weights as packed int8
#pragma unroll
  for (int j = 0; j < P3_NW; ++j) {
    unsigned packed = 0;
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * j + q;
      const int wv = (live && c < 2 * C) ? w_in[(size_t)c * N + n] : 0;
      packed |= (unsigned)(wv & 0xff) << (8 * q);
    }
    wpk[j] = (int)packed;
  }
  const int ds = live ? dash_syn[n] : 0;
  const int dm = live ? dash_mem[n] : 0;
  const int th = live ? thr[n] : 0;
  int isyn = 0, vmem = 0, cnt = 0;

  for (int t0 = 0; t0 < T; t0 += P3_TC) {
    const int len = min(P3_TC, T - t0);
    __syncthreads();  // the previous chunk's inputs are consumed
    for (int e = tx; e < len * nw; e += P3_NT) {
      const int i = e / nw, j = e % nw;
      const size_t row = ((size_t)(t0 + i) * B + b) * C;
      unsigned packed = 0;
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * j + q;
        unsigned v = 0;
        if (c < C)
          v = kp[row + c] != 0 && kn[row + c] == 0;
        else if (c < 2 * C)
          v = kn[row + c - C] != 0;
        packed |= v << (8 * q);
      }
      s_in[i * P3_NW + j] = (int)packed;
    }
    __syncthreads();
    // the dense currents of this thread's neuron: only it reads its column
    for (int i = 0; i < len; ++i) {
      int acc = 0;
#pragma unroll
      for (int j = 0; j < P3_NW; ++j)
        if (j < nw) acc = __dp4a(s_in[i * P3_NW + j], wpk[j], acc);
      s_cur[i * P3_NT + tx] = acc;
    }
    for (int i = 0; i < len; i += K) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (i + j < len)
          cnt += lif_step(isyn, vmem, s_cur[(i + j) * P3_NT + tx], ds, dm, th, live) ? 1 : 0;
    }
  }
  if (live) counts[(size_t)b * N + n] = cnt;
}

template <int K>
int launch_p3(const uint8_t* kp, const uint8_t* kn, const int* w_in, const int* ds, const int* dm,
              const int* thr, int* counts, int T, int B, int C, int N, cudaStream_t st) {
  const dim3 grid((N + P3_NT - 1) / P3_NT, B);
  probe_p3_kernel<K><<<grid, P3_NT, 0, st>>>(kp, kn, w_in, ds, dm, thr, counts, T, B, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hm_probe_p1(const int* x, int* out, long long n, int iters, int ilp, int blocks, int threads,
                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ilp) {
    case 1: return launch_p1<1>(x, out, n, iters, blocks, threads, st);
    case 2: return launch_p1<2>(x, out, n, iters, blocks, threads, st);
    case 4: return launch_p1<4>(x, out, n, iters, blocks, threads, st);
    case 8: return launch_p1<8>(x, out, n, iters, blocks, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int hm_probe_p2(const float* x, float* out, int nb, int TBe, int w, int rep, void* stream) {
  if (w < 1 || TBe != P2_TBE) return (int)cudaErrorInvalidValue;
  return launch_p2(x, out, nb, w, rep, (cudaStream_t)stream);
}

int hm_probe_p3_max_channels() { return P3_MAX_C; }

int hm_probe_p3(const uint8_t* kp, const uint8_t* kn, const int* w_in, const int* dash_syn,
                const int* dash_mem, const int* thr, int* counts, int T, int B, int C, int N,
                int k, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || C > P3_MAX_C) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 2: return launch_p3<2>(kp, kn, w_in, dash_syn, dash_mem, thr, counts, T, B, C, N, st);
    case 4: return launch_p3<4>(kp, kn, w_in, dash_syn, dash_mem, thr, counts, T, B, C, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
