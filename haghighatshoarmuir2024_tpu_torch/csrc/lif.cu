// Integer-LIF spike counts for Hopper (sm_90a): kernels K3 and K4 from the
// two RZCC polarity masks, K5 and K6 from one int8 spike raster.
//
// K3 replaces the Pallas kernel _lif_kernel_bipolar of
// haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:275 (public entry
// lif_count_rates_bipolar, :407).  K4 replaces _lif_kernel_bipolar_stateful
// (:468, public entry lif_count_stateful_bipolar, :605), the serving
// runtime's per-chunk LIF: K3 with the (B, N) isyn/vmem/spk state loaded at
// the start and stored at the end.  K5 replaces _lif_kernel (:76, public
// entry lif_count_rates, :218) and K6 _lif_kernel_stateful (:666, public
// entry lif_count_stateful, :802): the same dynamics, with the input current
// the product of an int8 raster of any values (multi-count, negative) with
// w_in, as the Pallas body's int8 x int8 -> int32 product (:106-115).
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
// Design: one thread per (b, n) chain; the T steps of a chain are
// sequential.  A block holds neurons of one batch row b, so every thread of a
// block sees the same input spikes: the block stages a chunk of steps in
// shared memory, and each thread adds the weights of the nonzero inputs only
// (RZCC spikes are sparse: about one per step at the flagship size).
//
//   K3/K4  pack each step's 2C mask bits into one 64-bit word (2C <= 64).
//   K5/K6  store each step's C int8 values and a bitmask of the nonzero ones
//          (C <= 128: one or two 64-bit words, a template parameter); a
//          thread adds v * w over the set bits.  The chunk of steps staged
//          is as long as fits 48 KB of shared memory beside the weights.
//
// Two layouts, by the uniform recurrence rec:
//
//   rec == 0  the B*N chains are independent.  Blocks of NT = 64 neurons; the
//             block's weight columns sit in shared memory, one per thread.
//   rec != 0  the chains of a row are coupled through sum_n spk_prev.  One
//             block holds all N <= 1024 neurons of a row, and the sum is one
//             __syncthreads_count per step.  The weights are read through the
//             read-only cache: at N = 1024 they would not fit in shared
//             memory.
//
// What bounds them on the card: the dependent integer chain of each step
// (about ten operations through isyn -> vmem -> spike), not memory: the
// inputs are read once per block and the only outputs are (B, N) arrays.
// The designs keep that chain free of divergence and of per-channel loops;
// filling the card better is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;        // neurons per block when rec == 0
constexpr int NT_MAX = 1024;  // neurons per block (one whole row) when rec != 0
constexpr int TCH = 1024;     // time steps staged per chunk
constexpr int STATE_MIN = -(1 << 15);
constexpr int STATE_MAX = (1 << 15) - 1;
constexpr int RASTER_MAX_C = 128;       // K5/K6: input channels, two 64-bit words
constexpr int RASTER_SMEM = 48 * 1024;  // K5/K6: dynamic shared memory per block

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

// The shared body of K3 and K4.  isyn0 == nullptr starts from zeros; the
// outputs isyn_out/vmem_out/spk_out are written only when non-null.  spk0
// holds 0/1 values, as the dynamics leave it.
template <bool CLIP, bool REC>
__device__ __forceinline__ void lif_bipolar_body(
    const uint8_t* __restrict__ kp, const uint8_t* __restrict__ kn,
    const int* __restrict__ w_in,  // (2C, N)
    const int* __restrict__ dash_syn, const int* __restrict__ dash_mem,
    const int* __restrict__ thr, int rec, const int* __restrict__ isyn0,
    const int* __restrict__ vmem0, const int* __restrict__ spk0, int* __restrict__ counts,
    int* __restrict__ isyn_out, int* __restrict__ vmem_out, int* __restrict__ spk_out, int T,
    int B, int C, int N) {
  extern __shared__ int s_w[];  // rec == 0: (2C, NT) weight columns of this block
  __shared__ unsigned long long s_mask[TCH];
  const int nt = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.y;
  const int n = blockIdx.x * nt + tx;
  const bool live = n < N;
  const size_t at = (size_t)b * N + n;

  if (!REC)
    for (int c = 0; c < 2 * C; ++c) s_w[c * nt + tx] = live ? w_in[(size_t)c * N + n] : 0;
  const int ds = live ? dash_syn[n] : 0;
  const int dm = live ? dash_mem[n] : 0;
  const int th = live ? thr[n] : 0;
  int isyn = 0, vmem = 0, spk = 0, cnt = 0;
  if (isyn0 != nullptr && live) {
    isyn = isyn0[at];
    vmem = vmem0[at];
    spk = spk0[at];
  }
  // the row's spike count of the previous step; every thread of the block
  // takes part in each __syncthreads_count
  int row_spikes = REC ? __syncthreads_count(spk != 0) : 0;

  for (int t0 = 0; t0 < T; t0 += TCH) {
    const int len = min(TCH, T - t0);
    __syncthreads();  // the previous chunk's masks are consumed
    for (int i = tx; i < len; i += nt) {
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
    if (!REC && !live) continue;
    for (int i = 0; i < len; ++i) {
      unsigned long long m = s_mask[i];
      int cur = REC ? rec * row_spikes : 0;
      while (m) {
        const int c = __ffsll((long long)m) - 1;
        if (REC)
          cur += live ? __ldg(&w_in[(size_t)c * N + n]) : 0;
        else
          cur += s_w[c * nt + tx];
        m &= m - 1;
      }
      const bool fired = lif_step<CLIP>(isyn, vmem, cur, ds, dm, th, live);
      cnt += fired ? 1 : 0;
      spk = fired ? 1 : 0;
      if (REC) row_spikes = __syncthreads_count(fired);
    }
  }
  if (live) {
    counts[at] = cnt;
    if (isyn_out != nullptr) {
      isyn_out[at] = isyn;
      vmem_out[at] = vmem;
      spk_out[at] = spk;
    }
  }
}

// K3: counts from a zero state.
template <bool CLIP, bool REC>
__global__ void lif_count_bipolar_kernel(const uint8_t* __restrict__ kp,
                                         const uint8_t* __restrict__ kn,
                                         const int* __restrict__ w_in,
                                         const int* __restrict__ dash_syn,
                                         const int* __restrict__ dash_mem,
                                         const int* __restrict__ thr, int rec,
                                         int* __restrict__ counts, int T, int B, int C, int N) {
  lif_bipolar_body<CLIP, REC>(kp, kn, w_in, dash_syn, dash_mem, thr, rec, nullptr, nullptr,
                              nullptr, counts, nullptr, nullptr, nullptr, T, B, C, N);
}

// K4: counts and the final state from a given state.
template <bool CLIP, bool REC>
__global__ void lif_count_stateful_bipolar_kernel(
    const uint8_t* __restrict__ kp, const uint8_t* __restrict__ kn,
    const int* __restrict__ w_in, const int* __restrict__ dash_syn,
    const int* __restrict__ dash_mem, const int* __restrict__ thr, int rec,
    const int* __restrict__ isyn0, const int* __restrict__ vmem0, const int* __restrict__ spk0,
    int* __restrict__ counts, int* __restrict__ isyn_out, int* __restrict__ vmem_out,
    int* __restrict__ spk_out, int T, int B, int C, int N) {
  lif_bipolar_body<CLIP, REC>(kp, kn, w_in, dash_syn, dash_mem, thr, rec, isyn0, vmem0, spk0,
                              counts, isyn_out, vmem_out, spk_out, T, B, C, N);
}

// Arguments of K5 and K6.  isyn0 == nullptr starts from zeros; the outputs
// isyn_out/vmem_out/spk_out are written only when non-null.
struct RasterArgs {
  const int8_t* spikes;  // (T, B, C)
  const int* w_in;       // (C, N)
  const int* dash_syn;
  const int* dash_mem;
  const int* thr;
  const int* isyn0;
  const int* vmem0;
  const int* spk0;
  int* counts;
  int* isyn_out;
  int* vmem_out;
  int* spk_out;
  int T, B, C, N, rec;
  int tch;  // time steps staged per chunk
};

// The shared body of K5 and K6.  Dynamic shared memory, in order: the
// block's (C, NT) weight columns (rec == 0 only), the (tch, NW) bitmasks of
// the nonzero inputs, the (tch, C) int8 values.
template <bool CLIP, bool REC, int NW>
__device__ __forceinline__ void lif_raster_body(const RasterArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, N = a.N, B = a.B;
  const int nt = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.y;
  const int n = blockIdx.x * nt + tx;
  const bool live = n < N;
  const size_t at = (size_t)b * N + n;
  int* s_w = reinterpret_cast<int*>(smem);
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(smem + (REC ? 0 : (size_t)C * nt * sizeof(int)));
  int8_t* s_val = reinterpret_cast<int8_t*>(s_mask + (size_t)a.tch * NW);

  if (!REC)
    for (int c = 0; c < C; ++c) s_w[c * nt + tx] = live ? a.w_in[(size_t)c * N + n] : 0;
  const int ds = live ? a.dash_syn[n] : 0;
  const int dm = live ? a.dash_mem[n] : 0;
  const int th = live ? a.thr[n] : 0;
  int isyn = 0, vmem = 0, spk = 0, cnt = 0;
  if (a.isyn0 != nullptr && live) {
    isyn = a.isyn0[at];
    vmem = a.vmem0[at];
    spk = a.spk0[at];
  }
  int row_spikes = REC ? __syncthreads_count(spk != 0) : 0;

  for (int t0 = 0; t0 < a.T; t0 += a.tch) {
    const int len = min(a.tch, a.T - t0);
    __syncthreads();  // the previous chunk's inputs are consumed
    for (int i = tx; i < len; i += nt) {
      const int8_t* row = a.spikes + ((size_t)(t0 + i) * B + b) * C;
      int8_t* val = s_val + (size_t)i * C;
      unsigned long long m0 = 0, m1 = 0;
      for (int c = 0; c < min(C, 64); ++c) {
        const int8_t v = row[c];
        val[c] = v;
        if (v != 0) m0 |= 1ull << c;
      }
      for (int c = 64; c < C; ++c) {
        const int8_t v = row[c];
        val[c] = v;
        if (v != 0) m1 |= 1ull << (c - 64);
      }
      s_mask[i * NW] = m0;
      if (NW == 2) s_mask[i * NW + 1] = m1;
    }
    __syncthreads();
    if (!REC && !live) continue;
    for (int i = 0; i < len; ++i) {
      const int8_t* val = s_val + (size_t)i * C;
      int cur = REC ? a.rec * row_spikes : 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        unsigned long long m = s_mask[i * NW + w];
        while (m) {
          const int c = (w << 6) + __ffsll((long long)m) - 1;
          const int wt = REC ? (live ? __ldg(&a.w_in[(size_t)c * N + n]) : 0) : s_w[c * nt + tx];
          cur += (int)val[c] * wt;
          m &= m - 1;
        }
      }
      const bool fired = lif_step<CLIP>(isyn, vmem, cur, ds, dm, th, live);
      cnt += fired ? 1 : 0;
      spk = fired ? 1 : 0;
      if (REC) row_spikes = __syncthreads_count(fired);
    }
  }
  if (live) {
    a.counts[at] = cnt;
    if (a.isyn_out != nullptr) {
      a.isyn_out[at] = isyn;
      a.vmem_out[at] = vmem;
      a.spk_out[at] = spk;
    }
  }
}

// K5: counts from a zero state.
template <bool CLIP, bool REC, int NW>
__global__ void lif_count_kernel(RasterArgs a) {
  lif_raster_body<CLIP, REC, NW>(a);
}

// K6: counts and the final state from a given state.
template <bool CLIP, bool REC, int NW>
__global__ void lif_count_stateful_kernel(RasterArgs a) {
  lif_raster_body<CLIP, REC, NW>(a);
}

// Block shape of both layouts: threads per block, grid, dynamic shared bytes.
struct Shape {
  dim3 grid;
  int threads;
  size_t smem;
};

Shape shape_for(int B, int C, int N, int rec) {
  if (rec != 0) return {dim3(1, B), (N + 31) / 32 * 32, 0};
  return {dim3((N + NT - 1) / NT, B), NT, (size_t)2 * C * NT * sizeof(int)};
}

// K5/K6: the shape of the layout, and the chunk of steps that fits beside
// the weights (a.tch is set here).
Shape raster_shape(RasterArgs& a, int nw) {
  const size_t wbytes = a.rec != 0 ? 0 : (size_t)a.C * NT * sizeof(int);
  const size_t per_step = (size_t)nw * sizeof(unsigned long long) + a.C;
  a.tch = (int)min((size_t)TCH, (RASTER_SMEM - wbytes) / per_step);
  const Shape s = shape_for(a.B, a.C, a.N, a.rec);
  return {s.grid, s.threads, wbytes + a.tch * per_step};
}

template <bool STATEFUL, bool CLIP, bool REC, int NW>
int launch_raster(RasterArgs a, cudaStream_t st) {
  const Shape s = raster_shape(a, NW);
  auto kernel = STATEFUL ? lif_count_stateful_kernel<CLIP, REC, NW> : lif_count_kernel<CLIP, REC, NW>;
  kernel<<<s.grid, s.threads, s.smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool STATEFUL, bool CLIP, bool REC>
int launch_raster_nw(const RasterArgs& a, cudaStream_t st) {
  return a.C > 64 ? launch_raster<STATEFUL, CLIP, REC, 2>(a, st)
                  : launch_raster<STATEFUL, CLIP, REC, 1>(a, st);
}

template <bool STATEFUL>
int dispatch_raster(const RasterArgs& a, int clip, void* stream) {
  if (a.C < 1 || a.C > RASTER_MAX_C) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (clip && a.rec) return launch_raster_nw<STATEFUL, true, true>(a, st);
  if (clip) return launch_raster_nw<STATEFUL, true, false>(a, st);
  if (a.rec) return launch_raster_nw<STATEFUL, false, true>(a, st);
  return launch_raster_nw<STATEFUL, false, false>(a, st);
}

}  // namespace

extern "C" {

int hm_lif_max_channels() { return 32; }

int hm_lif_max_rec_neurons() { return NT_MAX; }

int hm_lif_max_raster_channels() { return RASTER_MAX_C; }

// K5
int hm_lif_count(const int8_t* spikes, const int* w_in, const int* dash_syn, const int* dash_mem,
                 const int* thr, int* counts, int T, int B, int C, int N, int rec, int clip,
                 void* stream) {
  const RasterArgs a{spikes, w_in,    dash_syn, dash_mem, thr, nullptr, nullptr, nullptr,
                     counts, nullptr, nullptr,  nullptr,  T,   B,       C,       N,
                     rec,    0};
  return dispatch_raster<false>(a, clip, stream);
}

// K6
int hm_lif_count_stateful(const int8_t* spikes, const int* w_in, const int* dash_syn,
                          const int* dash_mem, const int* thr, const int* isyn0, const int* vmem0,
                          const int* spk0, int* counts, int* isyn_out, int* vmem_out,
                          int* spk_out, int T, int B, int C, int N, int rec, int clip,
                          void* stream) {
  const RasterArgs a{spikes, w_in,     dash_syn, dash_mem, thr, isyn0, vmem0, spk0,
                     counts, isyn_out, vmem_out, spk_out,  T,   B,     C,     N,
                     rec,    0};
  return dispatch_raster<true>(a, clip, stream);
}

int hm_lif_count_bipolar(const uint8_t* kp, const uint8_t* kn, const int* w_in, const int* dash_syn,
                         const int* dash_mem, const int* thr, int* counts, int T, int B, int C,
                         int N, int rec, int clip, void* stream) {
  const Shape s = shape_for(B, C, N, rec);
  const cudaStream_t st = (cudaStream_t)stream;
  if (clip && rec)
    lif_count_bipolar_kernel<true, true><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, counts, T, B, C, N);
  else if (clip)
    lif_count_bipolar_kernel<true, false><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, counts, T, B, C, N);
  else if (rec)
    lif_count_bipolar_kernel<false, true><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, counts, T, B, C, N);
  else
    lif_count_bipolar_kernel<false, false><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, counts, T, B, C, N);
  return (int)cudaGetLastError();
}

int hm_lif_count_stateful_bipolar(const uint8_t* kp, const uint8_t* kn, const int* w_in,
                                  const int* dash_syn, const int* dash_mem, const int* thr,
                                  const int* isyn0, const int* vmem0, const int* spk0,
                                  int* counts, int* isyn_out, int* vmem_out, int* spk_out, int T,
                                  int B, int C, int N, int rec, int clip, void* stream) {
  const Shape s = shape_for(B, C, N, rec);
  const cudaStream_t st = (cudaStream_t)stream;
  if (clip && rec)
    lif_count_stateful_bipolar_kernel<true, true><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, isyn0, vmem0, spk0, counts, isyn_out,
        vmem_out, spk_out, T, B, C, N);
  else if (clip)
    lif_count_stateful_bipolar_kernel<true, false><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, isyn0, vmem0, spk0, counts, isyn_out,
        vmem_out, spk_out, T, B, C, N);
  else if (rec)
    lif_count_stateful_bipolar_kernel<false, true><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, isyn0, vmem0, spk0, counts, isyn_out,
        vmem_out, spk_out, T, B, C, N);
  else
    lif_count_stateful_bipolar_kernel<false, false><<<s.grid, s.threads, s.smem, st>>>(
        kp, kn, w_in, dash_syn, dash_mem, thr, rec, isyn0, vmem0, spk0, counts, isyn_out,
        vmem_out, spk_out, T, B, C, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
