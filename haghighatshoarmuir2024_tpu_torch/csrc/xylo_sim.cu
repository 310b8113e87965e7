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
// Three kernels.  Without a recurrence (rec_coef = 0 and no dense w_rec: the
// flagship's w_rec is 0) no neuron waits on another, so xylo_sim_free_kernel
// takes the B x N neurons flat, a thread a neuron and FREE_THREADS to a
// block: every SM holds blocks, and where B * N is a multiple of 32 a warp's
// 32 neurons are one whole 128-byte line of each step's input and records
// (a block a batch row, as a row of 449 neurons starts 4 bytes into a
// sector, split every warp's load and stores over two lines and left their
// end sectors to be completed by other warps at other steps).  Its input is
// read FREE_AHEAD steps ahead into registers; its records go out a line a
// warp a step.  With a recurrence a row must see its whole row's spikes of
// the step before.  xylo_sim_kernel (a block a batch row, its T loop
// inside, each thread NPT neurons (n = k * blockDim + threadIdx) with isyn /
// vmem / spk in registers and the input read 16 / NPT steps ahead) costs
// one barrier a step: each warp's ballot of its spikes goes to one of two
// buffers of words in shared memory (the other holds the step before), and
// after the barrier each thread walks their set bits, each neuron adding its
// column's entry of every spiking neuron from global memory.  Each such
// entry is an L2 round trip behind the __ffs chain that finds it: about 430
// cycles a spike, 103.5-106.1 ms on the flagship's dense push-to-hidden
// block, 2.5 % of its bound.  It now runs only a dense w_rec that shared
// memory cannot hold (N = 4096, or int32 entries past N = 597), so always
// with 2, 4 or 8 neurons a thread; a uniform one takes the on-chip kernel,
// faster at every width measured (PERF.md §6).
//
// xylo_sim_onchip_kernel<S, W, REC, CLUSTER> holds w_rec on chip: a row is
// a cluster of c CTAs (c = 1, 2, 4 or 8; CLUSTER false for c = 1; a uniform
// w_rec always one CTA), CTA r
// owning the neurons r * Vc + k * nt + tid (k < S slots, nt threads, Vc =
// S * nt) and holding, for every presynaptic neuron m, each thread's S
// entries of W bytes side by side in shared memory: int8 stored + 128, int16
// or int32, the narrowest width that holds every entry, two int8 entries a
// thread (S = 2) and one of int16 or int32 (the wrapper's image,
// ops/cuda/sim_kernel.onchip_image, copied in once by cp.async; row N of the
// image is a row of zeros, the pad).  A step's spikes become a list of their
// indices: each warp reserves its spikes' places by one shared atomicAdd (on
// every CTA of the cluster, through distributed shared memory) and writes
// them there; after the one barrier a step (a cluster barrier, arrive after
// the writes and wait before the reads, or __syncthreads for c = 1) each
// thread sums its S entries over the list, 8 independent shared loads at a
// time, the next 8 indices loaded by one 16-byte load while these are
// summed.  A thread's two int8 entries are summed as the two 16-bit lanes
// of one add, widened every 256 entries.  Integer sums in any order equal the plain
// loop's float64 product.  The list buffers alternate by step and the counts
// rotate over three (the one for the step after next is zeroed each step),
// so one barrier a step keeps every reader ahead of the next writer.  A
// uniform w_rec takes the same kernel without the matrix, one CTA a row of
// S = 1, 2, 4 or 8 neurons a thread: rec_coef times the step's count.  The input current is read in one burst every 16 / S
// steps: a barrier waits for the loads its threads have in flight, and a
// load issued every step put a memory latency into every step (7.2 ms on the
// uniform -1 at N = 449 against 3.4 with the bursts, PERF.md §6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS_MAX = 512;
constexpr int NPT_MAX = 8;                      // neurons a thread
constexpr int N_MAX = THREADS_MAX * NPT_MAX;    // neurons a row
constexpr int WORDS_MAX = NPT_MAX * THREADS_MAX / 32;
constexpr int STATE_MIN = -32768, STATE_MAX = 32767;
constexpr int FREE_THREADS = 128;               // neurons a block without a recurrence
constexpr int FREE_AHEAD = 16;                  // steps of input current read ahead there
constexpr int ONCHIP_THREADS_MAX = 512;         // threads a CTA of xylo_sim_onchip_kernel
constexpr int ONCHIP_SMEM_MAX = 232448;         // dynamic shared memory a block may take on sm_90 (227 KB)
constexpr int ONCHIP_BLOCK = 8;                 // list entries a gather step loads at once
constexpr int ONCHIP_CHUNK = 256;               // int8 entries summed in 16-bit lanes: two sums of 128, 255 * 128 < 2^16
constexpr int ONCHIP_CLUSTER_MAX = 8;           // the portable cluster size

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

enum Rec { UNIFORM = 1, DENSE = 2 };  // the on-chip kernel's recurrences

// the global-memory row kernel, for a dense w_rec that shared memory cannot hold: a block a batch row, w_rec read
// from global memory (the header comment)
template <int NPT>
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
  if (a.spk0) {
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
      if (t > 0) {
        __syncthreads();  // the step before's spike words are all in words[buf ^ 1]
        const unsigned* w = words[buf ^ 1];
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
        const unsigned m = __ballot_sync(0xffffffffu, fire);
        if (lane == 0) words[buf][k * nw + warp] = m;
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
int launch_rec(const Args& a, int threads, cudaStream_t st) {
  xylo_sim_kernel<NPT><<<a.B, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- w_rec on chip
struct OnchipArgs {
  const uint4* image;  // (c, img_bytes / 16): CTA r's (N + 1) rows of w_rec, ops/cuda/sim_kernel.onchip_image
  int img_bytes;       // bytes of one CTA's image, a multiple of 16
  int cap;             // entries of a spike-list buffer
  int c;               // CTAs a row
};

// The plan's sizes, mirrored by ops/cuda/sim_kernel.py (onchip_threads, onchip_cap, onchip_image_bytes,
// onchip_smem): threads a CTA (whole warps on a cluster, so that lanes 0..c-1 of every warp exist), the
// list's entries (the gather reads ONCHIP_BLOCK past the last block it sums), a CTA's image (N + 1 rows of
// nt * S * W bytes, 16-byte padded) and its dynamic shared memory (the image, two lists of uint16, three
// counts).
__host__ __device__ inline int onchip_threads(int N, int S, int c) {
  const int per = ((N + c - 1) / c + S - 1) / S;
  return c == 1 ? per : (per + 31) / 32 * 32;
}
__host__ __device__ inline int onchip_cap(int N) {
  return (N + ONCHIP_BLOCK - 1) / ONCHIP_BLOCK * ONCHIP_BLOCK + ONCHIP_BLOCK;
}
__host__ __device__ inline long long onchip_image_bytes(int N, int nt, int S, int W) {
  return ((long long)(N + 1) * nt * S * W + 15) / 16 * 16;
}
inline long long onchip_smem(int N, int nt, int S, int W, int dense) {
  return dense ? onchip_image_bytes(N, nt, S, W) + 4LL * onchip_cap(N) + 16 : 16;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The entries a thread holds of one row of the image, as one load: two int8 + 128 (S = 2, W = 1), one int16
// or one int32 (S = 1).
template <int S, int W>
struct Entries {
  static_assert((S == 2 && W == 1) || (S == 1 && (W == 2 || W == 4)), "the dense forms sim_launch plans");
  using T = typename std::conditional<W == 1, unsigned short,
                                      typename std::conditional<W == 2, short, int>::type>::type;
};

// entry k of a thread's entries of row m (step 0's recurrence, from spk0's values)
template <int S, int W>
__device__ __forceinline__ int entry_at(const unsigned char* Wt, int k) {
  if constexpr (W == 1) return (int)Wt[k] - 128;
  else if constexpr (W == 2) return (int)reinterpret_cast<const short*>(Wt)[k];
  else return reinterpret_cast<const int*>(Wt)[k];
}

// rec[k] = the sum over the list's n indices m of w_rec[m, neuron k]: Wt is this thread's entries (row m
// at byte m * row_bytes), L the list, 16-byte aligned (its entries past n are rows of the image, never
// summed).  ONCHIP_BLOCK shared loads at a time, independent of one another, the next block's indices
// loaded by one 16-byte load while these are summed.  A thread's two int8 entries (stored + 128) are summed
// as two lanes of 16 bits to an add (__byte_perm), widened every ONCHIP_CHUNK entries less 128 an entry
// summed.
template <int S, int W>
__device__ __forceinline__ void gather(const unsigned char* Wt, int row_bytes, const unsigned short* L, int n,
                                       int (&rec)[S]) {
  using T = typename Entries<S, W>::T;
#pragma unroll
  for (int k = 0; k < S; ++k) rec[k] = 0;
  static_assert(ONCHIP_BLOCK == 8, "a block's indices are one uint4 of eight uint16");
  uint4 m = *reinterpret_cast<const uint4*>(L);
  int i = 0;
  while (i < n) {
    const int start = i, end = min(n, i + ONCHIP_CHUNK);
    unsigned lo0 = 0, lo1 = 0;  // int8: the two entries' sums, 16 bits a lane, two chains
    auto block = [&](bool masked) {
      const unsigned idx[4] = {m.x, m.y, m.z, m.w};
      T x[ONCHIP_BLOCK];
#pragma unroll
      for (int j = 0; j < ONCHIP_BLOCK; ++j)
        x[j] = *reinterpret_cast<const T*>(Wt + ((j & 1) ? idx[j / 2] >> 16 : idx[j / 2] & 0xffffu) * row_bytes);
      m = *reinterpret_cast<const uint4*>(L + i + ONCHIP_BLOCK);
#pragma unroll
      for (int j = 0; j < ONCHIP_BLOCK; ++j) {
        const bool pad = masked && i + j >= end;  // read as an entry of 0
        if constexpr (W == 1) {
          const unsigned v = pad ? 0x00800080u : __byte_perm((unsigned)x[j], 0, 0x4140);
          if (j & 1) lo1 += v; else lo0 += v;
        } else {
          rec[0] += pad ? 0 : (int)x[j];
        }
      }
    };
    for (; i + ONCHIP_BLOCK <= end; i += ONCHIP_BLOCK) block(false);
    if (i < end) {
      block(true);
      i += ONCHIP_BLOCK;
    }
    if constexpr (W == 1) {
      const int bias = 128 * (i - start);  // every entry summed, the pads' too, added 128
      rec[0] += (int)(lo0 & 0xffffu) + (int)(lo1 & 0xffffu) - bias;
      rec[1] += (int)(lo0 >> 16) + (int)(lo1 >> 16) - bias;
    }
  }
}

// A batch row on a cluster of c CTAs (CLUSTER false: c = 1; a uniform w_rec always one CTA), S neurons a
// thread, W bytes an on-chip entry of a dense w_rec (0: uniform), REC UNIFORM or DENSE (the header comment).
// __launch_bounds__'s one block an SM lets ptxas take the 128 registers a thread that 512 threads leave (left to
// itself it took 64 and spilled in the one-neuron-a-thread forms)
template <int S, int W, int REC, bool CLUSTER>
__global__ void __launch_bounds__(ONCHIP_THREADS_MAX, 1) xylo_sim_onchip_kernel(const Args a, const OnchipArgs o) {
  static_assert(REC == DENSE || !CLUSTER, "a uniform w_rec takes one CTA a row");
  // steps of input current read ahead, in one burst of loads every AHEAD steps: a barrier waits for the
  // loads its threads have in flight, so a load issued every step would put a memory latency in every step
  constexpr int AHEAD = 16 / S < 2 ? 2 : 16 / S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int c = CLUSTER ? o.c : 1;
  const int rank = CLUSTER ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const int N = a.N, T = a.T, Vc = S * nt;
  const long long row = (long long)(blockIdx.x / c) * N, step = (long long)a.B * N;
  const int img_bytes = REC == DENSE ? o.img_bytes : 0, row_bytes = nt * S * W;
  unsigned short* lists = reinterpret_cast<unsigned short*>(smem + img_bytes);                // 2 x cap, DENSE
  int* counts = reinterpret_cast<int*>(smem + img_bytes + (REC == DENSE ? 4 * o.cap : 0));  // 3
  const int lanes = min(32, nt - 32 * warp);
  const unsigned wmask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const unsigned char* Wt = smem + tid * S * W;  // this thread's entries of row 0

  if (REC == DENSE) {  // this CTA's image by cp.async; every list entry the pad row
    const uint4* src = o.image + (long long)rank * (o.img_bytes / 16);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    for (int i = tid; i < o.img_bytes / 16; i += nt)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i), "l"(src + i) : "memory");
    for (int i = tid; i < 2 * o.cap; i += nt) lists[i] = (unsigned short)N;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  for (int i = tid; i < 3; i += nt) counts[i] = 0;
  if (CLUSTER) {  // every CTA of the cluster started and set up before any writes into another
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  int isyn[S], vmem[S], spk[S], cnt[S], sds[S], sdm[S], th[S], rec[S], nid[S];
  bool live[S], fire[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    nid[k] = rank * Vc + k * nt + tid;
    live[k] = nid[k] < N;
    const int m = live[k] ? nid[k] : 0;
    isyn[k] = (live[k] && a.isyn0) ? a.isyn0[row + m] : 0;
    vmem[k] = (live[k] && a.vmem0) ? a.vmem0[row + m] : 0;
    spk[k] = (live[k] && a.spk0) ? a.spk0[row + m] : 0;
    sds[k] = shift_of(a.ds[m]);
    sdm[k] = shift_of(a.dm[m]);
    th[k] = a.th[m];
    cnt[k] = 0;
    rec[k] = 0;
    fire[k] = false;
  }

  // step 0's recurrence, from the initial spikes with their values
  if (a.spk0) {
    if constexpr (REC == UNIFORM) {
      int part = 0;
      for (int m = lane; m < N; m += lanes) part += a.spk0[row + m];
      const int total = __reduce_add_sync(wmask, part);
#pragma unroll
      for (int k = 0; k < S; ++k) rec[k] = a.rec_coef * total;
    } else {
      for (int m = 0; m < N; ++m) {
        const int v = a.spk0[row + m];
        if (v) {
#pragma unroll
          for (int k = 0; k < S; ++k) rec[k] += v * entry_at<S, W>(Wt + m * row_bytes, k);
        }
      }
    }
  }

  int cur[AHEAD][S], nxt[AHEAD][S];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u)
#pragma unroll
    for (int k = 0; k < S; ++k) nxt[u][k] = (live[k] && u < T) ? a.inp[u * step + row + nid[k]] : 0;
  int wbuf = 0;  // the counts buffer of this step's spikes: t % 3
  for (int t0 = 0; t0 < T; t0 += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
#pragma unroll
      for (int k = 0; k < S; ++k) {
        cur[u][k] = nxt[u][k];
        const int tn = t0 + AHEAD + u;
        nxt[u][k] = (live[k] && tn < T) ? a.inp[tn * step + row + nid[k]] : 0;
      }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = t0 + u;
      if (t >= T) break;  // uniform across the cluster
      int in[S];
#pragma unroll
      for (int k = 0; k < S; ++k) in[k] = cur[u][k];
      const int rbuf = wbuf == 0 ? 2 : wbuf - 1, zbuf = wbuf == 2 ? 0 : wbuf + 1;
      if (t > 0) {
        if (CLUSTER)
          cluster_wait();  // the step before's spikes are in every CTA's list and count
        else
          __syncthreads();
        const int n = counts[rbuf];
        if (tid == 0) counts[zbuf] = 0;  // read last at step t - 1, written next at step t + 1
        if constexpr (REC == UNIFORM) {
#pragma unroll
          for (int k = 0; k < S; ++k) rec[k] = a.rec_coef * n;
        } else {
          gather<S, W>(Wt, row_bytes, lists + ((t - 1) & 1) * o.cap, n, rec);
        }
      }
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int x = in[k] + rec[k];
        if (!a.integrate_first) {
          isyn[k] = sat(isyn[k] - (isyn[k] >> sds[k]) + x);
          vmem[k] = sat(vmem[k] - (vmem[k] >> sdm[k]) + isyn[k]);
        } else {
          const int xv = sat(isyn[k] + x);
          isyn[k] = sat(xv - (xv >> sds[k]));
          const int yv = sat(vmem[k] + isyn[k]);
          vmem[k] = sat(yv - (yv >> sdm[k]));
        }
        fire[k] = live[k] && vmem[k] >= th[k];
        spk[k] = fire[k] ? 1 : 0;
        if (a.reset_zero) {
          if (fire[k]) vmem[k] = 0;
        } else {
          vmem[k] -= spk[k] * th[k];
        }
        cnt[k] += spk[k];
      }
      {
        // this step's spikes: a warp's places reserved by one atomicAdd on each CTA's count, its indices
        // written at them (lane r reserves on CTA r)
        const unsigned lt = (1u << lane) - 1u;
        int off[S], nw = 0;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const unsigned bk = __ballot_sync(wmask, fire[k]);
          off[k] = nw + __popc(bk & lt);
          nw += __popc(bk);
        }
        if (nw) {  // uniform across the warp
          int* cw = counts + wbuf;
          if constexpr (REC == UNIFORM) {
            if (lane == 0) atomicAdd(cw, nw);
          } else {
            unsigned short* lw = lists + (t & 1) * o.cap;
            if constexpr (CLUSTER) {
              cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
              int base = 0;
              if (lane < c) base = atomicAdd(cl.map_shared_rank(cw, lane), nw);
              for (int r = 0; r < c; ++r) {
                const int br = __shfl_sync(0xffffffffu, base, r);
                unsigned short* lr = cl.map_shared_rank(lw, r);
#pragma unroll
                for (int k = 0; k < S; ++k)
                  if (fire[k]) lr[br + off[k]] = (unsigned short)nid[k];
              }
            } else {
              int base = 0;
              if (lane == 0) base = atomicAdd(cw, nw);
              base = __shfl_sync(wmask, base, 0);
#pragma unroll
              for (int k = 0; k < S; ++k)
                if (fire[k]) lw[base + off[k]] = (unsigned short)nid[k];
            }
          }
        }
        if (CLUSTER) cluster_arrive();
      }
      const long long at = t * step + row;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (!live[k]) continue;
        const long long p = at + nid[k];
        if (a.spikes) a.spikes[p] = spk[k];
        if (a.isyn_rec) a.isyn_rec[p] = isyn[k];
        if (a.vmem_rec) a.vmem_rec[p] = vmem[k];
      }
      wbuf = zbuf;
    }
  }
  if (CLUSTER) cluster_wait();  // no CTA leaves while another may still write into it
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (!live[k]) continue;
    const long long p = row + nid[k];
    a.isyn_f[p] = isyn[k];
    a.vmem_f[p] = vmem[k];
    a.spk_f[p] = spk[k];
    if (a.counts) a.counts[p] = cnt[k];
  }
}

// a dense form on a cluster of o.c CTAs a row, refused where the cluster cannot be placed
template <int S, int W>
int launch_onchip_cluster(const Args& a, const OnchipArgs& o, int nt, int smem, cudaStream_t st) {
  const auto kernel = xylo_sim_onchip_kernel<S, W, DENSE, true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * o.c);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = o.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, a, o);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int S, int W, int REC>
int launch_onchip(const Args& a, const OnchipArgs& o, int nt, int smem, cudaStream_t st) {
  if constexpr (REC == DENSE) {
    if (o.c > 1) return launch_onchip_cluster<S, W>(a, o, nt, smem, st);
  }
  const cudaError_t e = cudaFuncSetAttribute(xylo_sim_onchip_kernel<S, W, REC, false>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  xylo_sim_onchip_kernel<S, W, REC, false><<<a.B, nt, smem, st>>>(a, o);
  return (int)cudaGetLastError();
}

// The cluster barrier's latency (experiments/scan_kernels.py barrier): every thread of one cluster of
// CTAs passes reps barriers (cluster_mode 1: barrier.cluster arrive.release then wait.acquire, as the
// kernel; 2: arrive.relaxed then wait; 0: __syncthreads) between two clock64 reads, after 64 that warm
// the instruction cache; thread 0 of each CTA writes its cycles.
__device__ __forceinline__ void probe_barrier(int cluster_mode) {
  if (cluster_mode == 1) {
    cluster_arrive();
    cluster_wait();
  } else if (cluster_mode == 2) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    cluster_wait();
  } else {
    __syncthreads();
  }
}
__global__ void barrier_probe_kernel(int reps, int cluster_mode, long long* out) {
  for (int i = 0; i < 64; ++i) probe_barrier(cluster_mode);
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) probe_barrier(cluster_mode);
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" {

// the constants ops/cuda/sim_kernel.py mirrors: N_MAX, FREE_THREADS, THREADS_MAX, ONCHIP_THREADS_MAX,
// ONCHIP_SMEM_MAX, ONCHIP_BLOCK, ONCHIP_CLUSTER_MAX
void hm_xylo_sim_constants(int* out) {
  out[0] = N_MAX;
  out[1] = FREE_THREADS;
  out[2] = THREADS_MAX;
  out[3] = ONCHIP_THREADS_MAX;
  out[4] = ONCHIP_SMEM_MAX;
  out[5] = ONCHIP_BLOCK;
  out[6] = ONCHIP_CLUSTER_MAX;
}

// inp (T, B, N), ds / dm / th (N,), the initial state (B, N) each (each may
// be null: zeros), w_rec (N, N) when dense = 1, the records (T, B, N) and
// counts (B, N) where not null, the final state (B, N): all int32,
// contiguous.  With dense = 0, rec_coef must be 0 (no recurrence: a uniform
// one is hm_xylo_sim_onchip's).  T >= 1, B >= 1, 1 <= N <= 4096.  The launch
// (blocks, threads, npt) is ops/cuda/sim_kernel.sim_launch's: without a
// recurrence ceil(B * N / FREE_THREADS) blocks of FREE_THREADS threads, one
// neuron a thread; with a dense w_rec (the global-memory row kernel, which
// sim_launch plans only past the on-chip limits) B blocks of whole warps,
// npt (2, 4 or 8) neurons a thread, threads * npt >= N, at most THREADS_MAX
// threads.
int hm_xylo_sim(const int* inp, const int* ds, const int* dm, const int* th, const int* isyn0, const int* vmem0,
                const int* spk0, const int* w_rec, int* spikes, int* isyn_rec, int* vmem_rec, int* counts,
                int* isyn_f, int* vmem_f, int* spk_f, int T, int B, int N, int rec_coef, int dense,
                int integrate_first, int reset_zero, int blocks, int threads, int npt, void* stream) {
  if (T < 1 || B < 1 || N < 1 || N > N_MAX || (dense ? !w_rec : rec_coef != 0)) return (int)cudaErrorInvalidValue;
  const Args a{inp,   ds,       dm,       th,     isyn0,  vmem0, spk0, w_rec, spikes, isyn_rec, vmem_rec,
               counts, isyn_f, vmem_f, spk_f, T,     B,    N,     rec_coef, integrate_first, reset_zero};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!dense) {
    const long long M = (long long)B * N;
    if (threads != FREE_THREADS || npt != 1 || (long long)blocks * FREE_THREADS < M)
      return (int)cudaErrorInvalidConfiguration;
    xylo_sim_free_kernel<<<blocks, FREE_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (blocks != B || threads % 32 || threads > THREADS_MAX || threads * npt < N || (npt != 2 && npt != 4 && npt != 8))
    return (int)cudaErrorInvalidConfiguration;
  switch (npt) {
    case 2: return launch_rec<2>(a, threads, st);
    case 4: return launch_rec<4>(a, threads, st);
    default: return launch_rec<8>(a, threads, st);
  }
}


// The on-chip kernel (xylo_sim_onchip_kernel): the arguments of hm_xylo_sim without w_rec, and the plan of
// ops/cuda/sim_kernel.sim_launch: slots (S neurons a thread: with a dense w_rec, whose entries take width
// = W bytes, 2 for W = 1 and 1 for W = 2 or 4; 1, 2, 4 or 8 with a uniform one, width 0), cluster (c: 1, 2,
// 4 or 8 with a dense w_rec, 1 with a uniform one), threads (onchip_threads(N, S, c)) and, with dense = 1, image (c images of img_bytes =
// onchip_image_bytes(N, threads, S, W) bytes each, 16-byte aligned: sim_kernel.onchip_image).  With dense
// = 0, rec_coef != 0.  Checks the plan itself and refuses one that does not hold, or whose dynamic shared
// memory exceeds ONCHIP_SMEM_MAX, or whose cluster cannot be placed.
int hm_xylo_sim_onchip(const int* inp, const int* ds, const int* dm, const int* th, const int* isyn0,
                       const int* vmem0, const int* spk0, const void* image, int* spikes, int* isyn_rec,
                       int* vmem_rec, int* counts, int* isyn_f, int* vmem_f, int* spk_f, int T, int B, int N,
                       int rec_coef, int dense, int integrate_first, int reset_zero, int slots, int width,
                       int cluster, int threads, int img_bytes, void* stream) {
  if (T < 1 || B < 1 || N < 1 || N > N_MAX || (dense ? !image : !rec_coef)) return (int)cudaErrorInvalidValue;
  if (dense && ((unsigned long long)image & 15)) return (int)cudaErrorMisalignedAddress;
  const bool form_ok = dense ? ((width == 1 && slots == 2) || ((width == 2 || width == 4) && slots == 1))
                             : (width == 0 && cluster == 1 && (slots == 1 || slots == 2 || slots == 4 || slots == 8));
  if (!form_ok || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != ONCHIP_CLUSTER_MAX) ||
      threads != onchip_threads(N, slots, cluster) || threads > ONCHIP_THREADS_MAX ||
      (dense && img_bytes != onchip_image_bytes(N, threads, slots, width)))
    return (int)cudaErrorInvalidConfiguration;
  const long long smem = onchip_smem(N, threads, slots, width, dense);
  if (smem > ONCHIP_SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  const Args a{inp,   ds,       dm,       th,     isyn0,  vmem0, spk0, nullptr, spikes, isyn_rec, vmem_rec,
               counts, isyn_f, vmem_f, spk_f, T,     B,    N,     rec_coef, integrate_first, reset_zero};
  const OnchipArgs o{static_cast<const uint4*>(image), dense ? img_bytes : 0, onchip_cap(N), cluster};
  const cudaStream_t st = (cudaStream_t)stream;
  const int sm = (int)smem;
  if (dense) {
    switch (width) {
      case 1: return launch_onchip<2, 1, DENSE>(a, o, threads, sm, st);
      case 2: return launch_onchip<1, 2, DENSE>(a, o, threads, sm, st);
      default: return launch_onchip<1, 4, DENSE>(a, o, threads, sm, st);
    }
  }
  switch (slots) {
    case 1: return launch_onchip<1, 0, UNIFORM>(a, o, threads, sm, st);
    case 2: return launch_onchip<2, 0, UNIFORM>(a, o, threads, sm, st);
    case 4: return launch_onchip<4, 0, UNIFORM>(a, o, threads, sm, st);
    default: return launch_onchip<8, 0, UNIFORM>(a, o, threads, sm, st);
  }
}

// barrier_probe_kernel on one cluster of c CTAs of `threads` threads (cluster_mode 1 or 2; c = 1 a
// cluster of one) or on one block (cluster_mode 0, __syncthreads): out (c,) int64 on the card, each CTA's
// cycles over reps barriers.
int hm_barrier_probe(int c, int threads, int reps, int cluster_mode, long long* out, void* stream) {
  if (c < 1 || c > ONCHIP_CLUSTER_MAX || threads < 32 || threads > 1024 || reps < 1 || cluster_mode < 0 ||
      cluster_mode > 2 || (!cluster_mode && c != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!cluster_mode) {
    barrier_probe_kernel<<<1, threads, 0, st>>>(reps, 0, out);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, barrier_probe_kernel, reps, cluster_mode, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
