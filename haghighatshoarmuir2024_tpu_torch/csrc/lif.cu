// Integer-LIF spike counts from the two RZCC polarity masks, for Hopper
// (sm_90a): kernel K3.
//
// Replaces the Pallas kernel _lif_kernel_bipolar of
// haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:275 (public entry
// lif_count_rates_bipolar, :407).  Per step and neuron, with all state int32:
//
//   pos  = kp & ~kn                         (-1 wins on collision)
//   cur  = [pos | kn] @ w_in                 (2C input channels)
//   isyn = isyn - (isyn >> dash_syn) + cur   (arithmetic shift; clip to int16
//   vmem = vmem - (vmem >> dash_mem) + isyn   range unless proven dead)
//   spk  = vmem >= thr;  vmem -= spk * thr;  count += spk
//
// which is models/xylo/sim._sim_hidden with decay_first / subtract.  The
// uniform recurrence (w_rec = c * ones, c != 0) is not implemented here: the
// wrapper raises for it.
//
// Design: one thread per (b, n) chain; the B*N chains are independent when
// the recurrence is zero, and the T steps of a chain are sequential.  A block
// holds NT neurons of one batch row b, so every thread of a block sees the
// same input spikes: the block packs each step's 2C input bits into one
// 64-bit word in shared memory, and each thread adds the weights of the set
// bits (RZCC spikes are sparse: about one set bit per step at the flagship
// size).  The weight columns sit in shared memory, one column per thread.
//
// What bounds it on the card: the dependent integer chain of each step
// (about ten operations through isyn -> vmem -> spike), not memory: the
// masks are read once per block and the only output is the (B, N) counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;     // neurons per block
constexpr int TCH = 1024;  // time steps staged per chunk
constexpr int STATE_MIN = -(1 << 15);
constexpr int STATE_MAX = (1 << 15) - 1;

template <bool CLIP>
__global__ void lif_count_bipolar_kernel(const uint8_t* __restrict__ kp,
                                         const uint8_t* __restrict__ kn,
                                         const int* __restrict__ w_in,  // (2C, N)
                                         const int* __restrict__ dash_syn,
                                         const int* __restrict__ dash_mem,
                                         const int* __restrict__ thr, int* __restrict__ counts,
                                         int T, int B, int C, int N) {
  extern __shared__ int s_w[];  // (2C, NT) weight columns of this block
  __shared__ unsigned long long s_mask[TCH];
  const int tx = threadIdx.x;
  const int b = blockIdx.y;
  const int n = blockIdx.x * NT + tx;
  const bool live = n < N;

  for (int c = 0; c < 2 * C; ++c) s_w[c * NT + tx] = live ? w_in[(size_t)c * N + n] : 0;
  const int ds = live ? dash_syn[n] : 0;
  const int dm = live ? dash_mem[n] : 0;
  const int th = live ? thr[n] : 0;
  int isyn = 0, vmem = 0, cnt = 0;

  for (int t0 = 0; t0 < T; t0 += TCH) {
    const int len = min(TCH, T - t0);
    __syncthreads();  // the previous chunk's masks are consumed
    for (int i = tx; i < len; i += NT) {
      const size_t base = ((size_t)(t0 + i) * B + b) * C;
      unsigned long long m = 0;
      for (int c = 0; c < C; ++c) {
        const bool p = kp[base + c] != 0, q = kn[base + c] != 0;
        if (p && !q) m |= 1ull << c;
        if (q) m |= 1ull << (C + c);
      }
      s_mask[i] = m;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < len; ++i) {
      unsigned long long m = s_mask[i];
      int cur = 0;
      while (m) {
        cur += s_w[(__ffsll((long long)m) - 1) * NT + tx];
        m &= m - 1;
      }
      isyn = isyn - (isyn >> ds) + cur;
      if (CLIP) isyn = min(max(isyn, STATE_MIN), STATE_MAX);
      vmem = vmem - (vmem >> dm) + isyn;
      if (CLIP) vmem = min(max(vmem, STATE_MIN), STATE_MAX);
      if (vmem >= th) {
        vmem -= th;
        ++cnt;
      }
    }
  }
  if (live) counts[(size_t)b * N + n] = cnt;
}

}  // namespace

extern "C" {

int hm_lif_max_channels() { return 32; }

int hm_lif_count_bipolar(const uint8_t* kp, const uint8_t* kn, const int* w_in, const int* dash_syn,
                         const int* dash_mem, const int* thr, int* counts, int T, int B, int C,
                         int N, int clip, void* stream) {
  const dim3 grid((N + NT - 1) / NT, B);
  const size_t smem = (size_t)2 * C * NT * sizeof(int);
  if (clip)
    lif_count_bipolar_kernel<true><<<grid, NT, smem, (cudaStream_t)stream>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, counts, T, B, C, N);
  else
    lif_count_bipolar_kernel<false><<<grid, NT, smem, (cudaStream_t)stream>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, counts, T, B, C, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
