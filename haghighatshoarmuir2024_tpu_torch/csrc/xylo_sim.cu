// The integer hidden-layer LIF of the Xylo simulator for Hopper (sm_90a):
// models/xylo/sim.scan_hidden over all T steps in one launch (JAX
// _sim_hidden, models/xylo/sim.py:60-124, one jax.lax.scan).
//
// Replaces no TPU kernel: the JAX package runs the simulator as a lax.scan,
// and the port's plain version (sim.scan_hidden_plain) is a Python loop of
// about 11 tensor ops a step, host-bound on the card.  Per step, per neuron,
// all int32, in the step conventions of sim.py's docstring:
//
//   decay_first:     isyn = sat(isyn - (isyn >> ds) + inp + rec)
//                    vmem = sat(vmem - (vmem >> dm) + isyn)
//   integrate_first: x = sat(isyn + inp + rec); isyn = sat(x - (x >> ds))
//                    y = sat(vmem + isyn);      vmem = sat(y - (y >> dm))
//   spk = vmem >= th;  subtract: vmem -= spk * th;  zero: vmem = spk ? 0 : vmem
//
// with sat the 16-bit state range and >> PyTorch's int32 shift (a shift
// below 0 or above 30 shifts by 31).  rec is the previous step's spikes of
// the same batch row through w_rec: rec_coef * sum(spk) for a uniform w_rec,
// sum_m spk[m] * w_rec[m, n] for a dense one.  Both are exact integer sums,
// so each equals the plain version's float64 product cast to int32, and every
// output equals the plain loop's bit for bit.  At step 0 the spikes are the
// initial state's, read with their values; after it they are 0 or 1.
//
// What bounds it on the card: the bytes, the input current in and the
// records out (int32 (T, B, N) each, written as the steps go), 8.3 GB at 96
// frames of the flagship with all three records; a call with few rows is
// bound by the step's chain instead (about a dozen dependent integer
// operations, plus a barrier with a recurrence).
//
// Two kernels.  Without a recurrence (rec_coef = 0 and no dense w_rec: the
// flagship's w_rec is 0) no neuron waits on another, so xylo_sim_free_kernel
// takes the B x N neurons flat, a thread a neuron and FREE_THREADS to a
// block: every SM holds blocks, and where B * N is a multiple of 32 a warp's
// 32 neurons are one whole 128-byte line of each step's input and records
// (a block a batch row, as a row of 449 neurons starts 4 bytes into a
// sector, split every warp's load and stores over two lines and left their
// end sectors to be completed by other warps at other steps).  Its input is
// read FREE_AHEAD steps ahead into registers; its records go out a line a
// warp a step.  With a recurrence a block must see its whole row's spikes of
// the step before, so xylo_sim_kernel keeps a block a batch row, its T loop
// inside, each thread NPT neurons (n = k * blockDim + threadIdx) with isyn /
// vmem / spk in registers and the input read 16 / NPT steps ahead.
// The recurrence costs one barrier a step: each warp's ballot of its spikes
// goes to one of two buffers of words in shared memory (the other holds the
// step before), and after the barrier a uniform w_rec sums their popcounts
// (a lane a word, then a warp sum) and a dense one walks their set bits,
// each neuron adding its column's entry of every spiking neuron from global
// memory (L2-resident: 7.3 MB at N = 1347).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS_MAX = 512;
constexpr int NPT_MAX = 8;                      // neurons a thread
constexpr int N_MAX = THREADS_MAX * NPT_MAX;    // neurons a row
constexpr int WORDS_MAX = NPT_MAX * THREADS_MAX / 32;
constexpr int STATE_MIN = -32768, STATE_MAX = 32767;
constexpr int FREE_THREADS = 128;               // neurons a block without a recurrence
constexpr int FREE_AHEAD = 16;                  // steps of input current read ahead there

struct Args {
  const int* inp;                  // (T, B, N)
  const int *ds, *dm, *th;         // (N,)
  const int *isyn0, *vmem0, *spk0;  // (B, N) each, or null: zeros
  const int* w_rec;                // (N, N), dense only
  int* spikes;                     // (T, B, N) or null
  int *isyn_rec, *vmem_rec;        // (T, B, N) each, or null
  int* counts;                     // (B, N) or null
  int *isyn_f, *vmem_f, *spk_f;    // (B, N)
  int T, B, N, rec_coef, integrate_first, reset_zero;
};

__device__ __forceinline__ int sat(int v) { return min(max(v, STATE_MIN), STATE_MAX); }

// PyTorch's int32 >>: a shift count below 0 or at least 31 shifts by 31
__device__ __forceinline__ int shift_of(int d) { return (d < 0 || d >= 31) ? 31 : d; }

// one step of one neuron of the flat kernel in the conventions above: isyn and vmem updated, the spike returned
// (xylo_sim_kernel spells out the same step)
__device__ __forceinline__ int lif_step(int& isyn, int& vmem, int in, int sds, int sdm, int th, int integrate_first,
                                        int reset_zero) {
  if (!integrate_first) {
    isyn = sat(isyn - (isyn >> sds) + in);
    vmem = sat(vmem - (vmem >> sdm) + isyn);
  } else {
    const int xv = sat(isyn + in);
    isyn = sat(xv - (xv >> sds));
    const int yv = sat(vmem + isyn);
    vmem = sat(yv - (yv >> sdm));
  }
  const bool fire = vmem >= th;
  const int spk = fire ? 1 : 0;
  if (reset_zero) {
    if (fire) vmem = 0;
  } else {
    vmem -= spk * th;
  }
  return spk;
}

// no recurrence: neuron m of the flat (B, N) batch, a thread each
__global__ void __launch_bounds__(FREE_THREADS) xylo_sim_free_kernel(const Args a) {
  const long long M = (long long)a.B * a.N;
  const long long m = (long long)blockIdx.x * FREE_THREADS + threadIdx.x;
  if (m >= M) return;  // no barrier: a thread past the end may leave
  const int n = (int)(m % a.N), T = a.T;
  int isyn = a.isyn0 ? a.isyn0[m] : 0, vmem = a.vmem0 ? a.vmem0[m] : 0, spk = 0, cnt = 0;
  const int sds = shift_of(a.ds[n]), sdm = shift_of(a.dm[n]), th = a.th[n];
  const int* __restrict__ ip = a.inp + m;
  int* __restrict__ sp = a.spikes ? a.spikes + m : nullptr;
  int* __restrict__ ir = a.isyn_rec ? a.isyn_rec + m : nullptr;
  int* __restrict__ vr = a.vmem_rec ? a.vmem_rec + m : nullptr;
  int cur[FREE_AHEAD], nxt[FREE_AHEAD];
#pragma unroll
  for (int u = 0; u < FREE_AHEAD; ++u) nxt[u] = u < T ? ip[u * M] : 0;
  for (int t0 = 0; t0 < T; t0 += FREE_AHEAD) {
#pragma unroll
    for (int u = 0; u < FREE_AHEAD; ++u) {
      cur[u] = nxt[u];
      const int t = t0 + FREE_AHEAD + u;
      nxt[u] = t < T ? ip[t * M] : 0;
    }
#pragma unroll
    for (int u = 0; u < FREE_AHEAD; ++u) {
      const int t = t0 + u;
      if (t >= T) break;
      spk = lif_step(isyn, vmem, cur[u], sds, sdm, th, a.integrate_first, a.reset_zero);
      cnt += spk;
      const long long o = t * M;
      if (sp) sp[o] = spk;
      if (ir) ir[o] = isyn;
      if (vr) vr[o] = vmem;
    }
  }
  a.isyn_f[m] = isyn;
  a.vmem_f[m] = vmem;
  a.spk_f[m] = spk;
  if (a.counts) a.counts[m] = cnt;
}

enum Rec { NONE = 0, UNIFORM = 1, DENSE = 2 };  // NONE: xylo_sim_free_kernel

template <int NPT, int REC>
__global__ void __launch_bounds__(THREADS_MAX) xylo_sim_kernel(const Args a) {
  constexpr int UNROLL = 16 / NPT;  // steps of input current read ahead
  __shared__ unsigned words[2][WORDS_MAX];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5, nwords = NPT * nw;
  const int N = a.N, T = a.T;
  const long long row = (long long)b * N, step = (long long)a.B * N;

  int isyn[NPT], vmem[NPT], spk[NPT], cnt[NPT], sds[NPT], sdm[NPT], th[NPT], rec[NPT];
  bool live[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int n = k * nt + tid;
    live[k] = n < N;
    const int m = live[k] ? n : 0;
    isyn[k] = (live[k] && a.isyn0) ? a.isyn0[row + m] : 0;
    vmem[k] = (live[k] && a.vmem0) ? a.vmem0[row + m] : 0;
    spk[k] = (live[k] && a.spk0) ? a.spk0[row + m] : 0;
    sds[k] = shift_of(a.ds[m]);
    sdm[k] = shift_of(a.dm[m]);
    th[k] = a.th[m];
    cnt[k] = 0;
    rec[k] = 0;
  }

  // step 0's recurrence, from the initial spikes with their values
  if (REC == UNIFORM && a.spk0) {
    int total = 0;
    for (int m = 0; m < N; ++m) total += a.spk0[row + m];
#pragma unroll
    for (int k = 0; k < NPT; ++k) rec[k] = a.rec_coef * total;
  } else if (REC == DENSE && a.spk0) {
    for (int m = 0; m < N; ++m) {
      const int v = a.spk0[row + m];
      if (v) {
#pragma unroll
        for (int k = 0; k < NPT; ++k)
          if (live[k]) rec[k] += v * a.w_rec[(long long)m * N + k * nt + tid];
      }
    }
  }

  int cur[UNROLL][NPT], nxt[UNROLL][NPT];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
#pragma unroll
    for (int k = 0; k < NPT; ++k) nxt[u][k] = (live[k] && u < T) ? a.inp[u * step + row + k * nt + tid] : 0;
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        cur[u][k] = nxt[u][k];
        const int t = t0 + UNROLL + u;
        nxt[u][k] = (live[k] && t < T) ? a.inp[t * step + row + k * nt + tid] : 0;
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t >= T) break;  // uniform across the block
      if (REC != NONE && t > 0) {
        __syncthreads();  // the step before's spike words are all in words[buf ^ 1]
        const unsigned* w = words[buf ^ 1];
        if (REC == UNIFORM) {
          int part = 0;
          for (int i = lane; i < nwords; i += 32) part += __popc(w[i]);
          const int total = __reduce_add_sync(0xffffffffu, part);
#pragma unroll
          for (int k = 0; k < NPT; ++k) rec[k] = a.rec_coef * total;
        } else {
#pragma unroll
          for (int k = 0; k < NPT; ++k) rec[k] = 0;
          for (int i = 0; i < nwords; ++i) {
            unsigned bits = w[i];
            const int base = (i / nw) * nt + (i % nw) * 32;  // word i: slot i / nw of warp i % nw
            while (bits) {
              const int m = base + __ffs(bits) - 1;
              bits &= bits - 1;
              const int* wr = a.w_rec + (long long)m * N + tid;
#pragma unroll
              for (int k = 0; k < NPT; ++k)
                if (live[k]) rec[k] += wr[k * nt];
            }
          }
        }
      }
      const long long at = t * step + row + tid;
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        const int in = cur[u][k] + rec[k];
        if (!a.integrate_first) {
          isyn[k] = sat(isyn[k] - (isyn[k] >> sds[k]) + in);
          vmem[k] = sat(vmem[k] - (vmem[k] >> sdm[k]) + isyn[k]);
        } else {
          const int xv = sat(isyn[k] + in);
          isyn[k] = sat(xv - (xv >> sds[k]));
          const int yv = sat(vmem[k] + isyn[k]);
          vmem[k] = sat(yv - (yv >> sdm[k]));
        }
        const bool fire = live[k] && vmem[k] >= th[k];
        spk[k] = fire ? 1 : 0;
        if (a.reset_zero) {
          if (fire) vmem[k] = 0;
        } else {
          vmem[k] -= spk[k] * th[k];
        }
        cnt[k] += spk[k];
        if (REC != NONE) {
          const unsigned m = __ballot_sync(0xffffffffu, fire);
          if (lane == 0) words[buf][k * nw + warp] = m;
        }
        if (live[k]) {
          const long long o = at + k * nt;
          if (a.spikes) a.spikes[o] = spk[k];
          if (a.isyn_rec) a.isyn_rec[o] = isyn[k];
          if (a.vmem_rec) a.vmem_rec[o] = vmem[k];
        }
      }
      buf ^= 1;
    }
  }
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    if (!live[k]) continue;
    const long long o = row + k * nt + tid;
    a.isyn_f[o] = isyn[k];
    a.vmem_f[o] = vmem[k];
    a.spk_f[o] = spk[k];
    if (a.counts) a.counts[o] = cnt[k];
  }
}

template <int NPT>
int launch_rec(const Args& a, int dense, int threads, cudaStream_t st) {
  if (dense)
    xylo_sim_kernel<NPT, DENSE><<<a.B, threads, 0, st>>>(a);
  else
    xylo_sim_kernel<NPT, UNIFORM><<<a.B, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the constants ops/cuda/sim_kernel.py mirrors: N_MAX, FREE_THREADS, THREADS_MAX
void hm_xylo_sim_constants(int* out) {
  out[0] = N_MAX;
  out[1] = FREE_THREADS;
  out[2] = THREADS_MAX;
}

// inp (T, B, N), ds / dm / th (N,), the initial state (B, N) each (each may
// be null: zeros), w_rec (N, N) when dense = 1, the records (T, B, N) and
// counts (B, N) where not null, the final state (B, N): all int32,
// contiguous.  rec_coef is used when dense = 0 (0: no recurrence).
// T >= 1, B >= 1, 1 <= N <= 4096.  The launch (blocks, threads, npt) is
// ops/cuda/sim_kernel.sim_launch's: without a recurrence ceil(B * N /
// FREE_THREADS) blocks of FREE_THREADS threads, one neuron a thread; with
// one B blocks of whole warps, npt (1, 2, 4 or 8) neurons a thread,
// threads * npt >= N, at most THREADS_MAX threads.
int hm_xylo_sim(const int* inp, const int* ds, const int* dm, const int* th, const int* isyn0, const int* vmem0,
                const int* spk0, const int* w_rec, int* spikes, int* isyn_rec, int* vmem_rec, int* counts,
                int* isyn_f, int* vmem_f, int* spk_f, int T, int B, int N, int rec_coef, int dense,
                int integrate_first, int reset_zero, int blocks, int threads, int npt, void* stream) {
  if (T < 1 || B < 1 || N < 1 || N > N_MAX || (dense && !w_rec)) return (int)cudaErrorInvalidValue;
  const Args a{inp,   ds,       dm,       th,     isyn0,  vmem0, spk0, w_rec, spikes, isyn_rec, vmem_rec,
               counts, isyn_f, vmem_f, spk_f, T,     B,    N,     rec_coef, integrate_first, reset_zero};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!dense && !rec_coef) {
    const long long M = (long long)B * N;
    if (threads != FREE_THREADS || npt != 1 || (long long)blocks * FREE_THREADS < M)
      return (int)cudaErrorInvalidConfiguration;
    xylo_sim_free_kernel<<<blocks, FREE_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (blocks != B || threads % 32 || threads > THREADS_MAX || threads * npt < N ||
      (npt != 1 && npt != 2 && npt != 4 && npt != 8))
    return (int)cudaErrorInvalidConfiguration;
  switch (npt) {
    case 1: return launch_rec<1>(a, dense, threads, st);
    case 2: return launch_rec<2>(a, dense, threads, st);
    case 4: return launch_rec<4>(a, dense, threads, st);
    default: return launch_rec<8>(a, dense, threads, st);
  }
}

}  // extern "C"
