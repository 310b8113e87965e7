// The two DoA trackers on the circle for Hopper (sm_90a): utils/tracking.py's
// track_angles and track_multi_angles over all T frames in one launch each
// (JAX track_angles, utils/tracking.py:155, and track_multi_angles, :400:
// one jax.lax.scan each).
//
// Replace no TPU kernel: the JAX package runs both trackers as lax.scans, and
// the port's plain versions (track_angles_plain, track_multi_angles_plain)
// are Python loops of tensor ops a frame (about 60 for the alpha-beta step,
// a few hundred for the multi-target step), host-bound on the card.
//
// track_angles_kernel, per frame, as track_step (utils/tracking.py:64-95):
//   init 0 (empty):  theta = z, omega = 0, misses = 0, init = 1
//   init 1 (booting): omega = wrap(z - theta), theta = z, misses = 0, init = 2
//   otherwise: pred = wrap(theta + omega), delta = wrap(z - pred),
//     inlier = |delta| <= gate;  m = inlier ? 0 : misses + 1
//     m > max_misses: theta = z, omega = 0, misses = 0, init = 1   (re-acquire)
//     else inlier:    theta = wrap(pred + alpha·delta), omega = omega + beta·delta, misses = 0
//     else:           theta = pred, misses = m                      (coast)
//   the output is theta.
// track_multi_kernel, per frame, as multi_track_step (:181-259): each slot's
// prediction; the (M, K) cost |wrap(z_k - pred_m)|, inf where the slot is
// empty, the measurement invalid or the distance beyond the slot's gate
// (gate when tracking, pi when booting); the greedy assignment, min(M, K)
// rounds of the first minimum in row-major order, its row and column then
// closed, stopping at the first round whose minimum is inf (every later round
// of the plain loop changes nothing); the alpha-beta update of assigned
// tracking slots and the coast of unassigned ones; the bootstrap of assigned
// booting slots; deaths (an unassigned booting slot, a coasting slot past
// max_misses); each leftover valid measurement, in order, spawning in the
// first empty slot; the outputs theta and confirmed = (init == 2 and hits >=
// confirm_hits).
//
// wrap(x) = atan2f(sinf(x), cosf(x)), CUDA's accurate functions, as
// PyTorch's sin, cos and atan2 kernels call them (no fast math here or
// there), computed as atan2f of sincosf's pair: the same bits at every
// float32 (below).  The plain versions' Python scalars reach PyTorch's kernels as
// float32: alpha, beta and gate (a float32 tensor compared with a Python
// float compares with the float rounded to float32), and the multi-target
// gates gate and pi (a float32 tensor from torch.where); the wrapper rounds
// them and passes float32.  Every sum, difference and product is rounded on
// its own (__fadd_rn, __fsub_rn, __fmul_rn: nothing contracts into an FMA),
// so every output equals the plain loop's bit for bit.
//
// What bounds them on the card: a frame's dependent chain of wraps (the
// bytes and the lanes are far too few to matter at every shape the port
// runs, 240 frames x 96 lanes).  One wrap is about 300 cycles of
// dependent operations (wrap_chain_kernel measures it), so a frame of the
// alpha-beta step costs at least three of them (the prediction, the
// innovation, the update) and a multi-target frame three plus its
// assignment rounds.  What the designs do about it:
//   track_angles_kernel: a thread a lane; every lane computes exactly the
//     three wraps a frame, each on an argument selected first (z - theta
//     when booting, z - pred otherwise), and the state machine is selects,
//     so the lanes of a warp never diverge on their states; the lane's z
//     comes from shared memory, staged STAGE_ANGLES frames at a time, the
//     next stage's loads issued into registers before the current stage's
//     frames run.
//   track_multi_kernel: a warp a lane, thread m slot m, its state, its row
//     of K costs and wrapped differences in registers (loops over the
//     compile-time capacity KC, an index known only at run time applied by
//     unrolled compare-and-select), the wraps of all KC columns computed
//     with no branch between them (z = 0 past K); the
//     greedy rounds as warp reductions (__reduce_min_sync of the row minima's
//     bits, then of the index m·KC + k among the rows that hold it: the
//     plain loop's row-major first minimum); the update's two wraps (a
//     booting slot's wrap(z_k - theta), a tracking slot's wrap(pred +
//     alpha·delta)) one wrap on a selected argument; spawns by one ballot of
//     the empty slots, the r-th leftover measurement to the r-th empty slot;
//     the lane's (frame, measurement) values staged in shared memory as
//     above, STAGE_MULTI at a time.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;      // a block: lanes (track_angles), or 4 warps each a lane (track_multi)
constexpr int M_MAX = 16;         // track slots a lane
constexpr int K_MAX = 16;         // measurements a frame
constexpr int STAGE_ANGLES = 16;  // frames of z a thread stages at a time
constexpr int STAGE_MULTI = 256;  // (frame, measurement) values a warp stages at a time
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;

// one reduction of x for both functions: sincosf's pair equals sinf's and cosf's at every float32 (the card,
// all 2^32 patterns on an H100, scan_kernels.wrap_bits), and a chain of (an add, this wrap) takes 309 cycles a link
// against 354 for atan2f(sinf(x), cosf(x)), whose sinf and cosf run one after the other
// (scan_kernels.wrap_latency).  The reduction's slow path (|x| >= 105 615: Payne-Hanek, its words in local
// memory) is one function out of line, so a kernel's loop holds the fast paths alone (the shorter loop ran
// faster on an H100: a frame of track_angles_kernel 1150 cycles against 1242 with every slow path inline)
__device__ __noinline__ float wrap_far(float x) {
  float s, c;
  sincosf(x, &s, &c);
  return atan2f(s, c);
}

__device__ __forceinline__ float wrap(float x) {
  if (fabsf(x) >= 105615.0f) return wrap_far(x);
  float s, c;
  sincosf(x, &s, &c);
  return atan2f(s, c);
}

// PyTorch's int32 + 1 wraps around; signed overflow in C++ does not
__device__ __forceinline__ int inc(int v) { return (int)((unsigned)v + 1u); }

struct TrackArgs {
  const float* z;  // (T, L)
  float* theta;    // (T, L)
  int T, L, max_misses;
  float alpha, beta, gate;
};

__global__ void __launch_bounds__(THREADS) track_angles_kernel(const TrackArgs a) {
  __shared__ float zs[STAGE_ANGLES][THREADS];
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= a.L) return;  // no block barrier below: each thread reads only its own column
  float theta = 0.0f, omega = 0.0f;
  int misses = 0, init = 0;
  const float* __restrict__ zp = a.z + j;
  float* __restrict__ out = a.theta + j;
  float nz[STAGE_ANGLES];
#pragma unroll
  for (int i = 0; i < STAGE_ANGLES; ++i) nz[i] = i < a.T ? zp[(long long)i * a.L] : 0.0f;
  for (int t0 = 0; t0 < a.T; t0 += STAGE_ANGLES) {
#pragma unroll
    for (int i = 0; i < STAGE_ANGLES; ++i) zs[i][threadIdx.x] = nz[i];
    const int next = t0 + STAGE_ANGLES;
#pragma unroll
    for (int i = 0; i < STAGE_ANGLES; ++i)  // the next stage in flight while this one runs
      nz[i] = next + i < a.T ? zp[(long long)(next + i) * a.L] : 0.0f;
    const int n = a.T - t0 < STAGE_ANGLES ? a.T - t0 : STAGE_ANGLES;
    for (int i = 0; i < n; ++i) {
      const float z = zs[i][threadIdx.x];
      const float pred = wrap(__fadd_rn(theta, omega));
      // booting: omega's wrap(z - theta); otherwise the innovation wrap(z - pred)
      const float w2 = wrap(__fsub_rn(z, init == 1 ? theta : pred));
      const bool inlier = fabsf(w2) <= a.gate;
      const int m = inlier ? 0 : inc(misses);
      const float w3 = wrap(__fadd_rn(pred, __fmul_rn(a.alpha, w2)));
      const float om_upd = __fadd_rn(omega, __fmul_rn(a.beta, w2));
      const bool tracking = init == 2, reacquire = m > a.max_misses;
      const float th_track = reacquire ? z : (inlier ? w3 : pred);
      const float om_track = reacquire ? 0.0f : (inlier ? om_upd : omega);
      theta = tracking ? th_track : z;
      omega = tracking ? om_track : (init == 1 ? w2 : 0.0f);
      misses = tracking && !reacquire ? m : 0;
      init = tracking ? (reacquire ? 1 : 2) : init + 1;
      out[(long long)(t0 + i) * a.L] = theta;
    }
  }
}

struct MultiArgs {
  const float* z;            // (T, L, K)
  const unsigned char* valid;  // (T, L, K), 0 or 1
  float* theta;              // (T, L, M)
  unsigned char* confirmed;  // (T, L, M), 0 or 1
  int T, L, M, K, max_misses, confirm_hits;
  float alpha, beta, gate, pi;
};

// KC: the capacity the measurement loops run to (K <= KC), so a frame of K = 2 runs loops of 2
template <int KC>
__global__ void __launch_bounds__(THREADS) track_multi_kernel(const MultiArgs a) {
  static_assert(KC >= 1 && KC <= K_MAX && (KC & (KC - 1)) == 0, "KC: a power of two up to K_MAX");
  constexpr int PER = STAGE_MULTI / 32;  // staged values a thread loads
  __shared__ float zs[WARPS][STAGE_MULTI];
  __shared__ unsigned char vs[WARPS][STAGE_MULTI];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + w;
  if (j >= a.L) return;  // the whole warp: no block barrier below
  const int M = a.M, K = a.K, T = a.T;
  const int frames = STAGE_MULTI / K;  // frames a stage
  const float inf = __int_as_float((int)INF_BITS);
  const bool slot = lane < M;
  float th = 0.0f, om = 0.0f;
  int mi = 0, in = 0, hi = 0;

  // the lane's (frame, measurement) values of frames t0 .. t0 + frames - 1, value e = lane + 32 i of a stage
  float pz[PER];
  unsigned char pv[PER];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = lane + 32 * i, f = e / K, k = e - f * K;
      pz[i] = 0.0f;
      pv[i] = 0;
      if (f < frames && t0 + f < T) {
        const long long o = ((long long)(t0 + f) * a.L + j) * K + k;
        pz[i] = a.z[o];
        pv[i] = a.valid[o];
      }
    }
  };
  load(0);
  for (int t0 = 0; t0 < T; t0 += frames) {
    __syncwarp();  // the last stage's frames are read
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      zs[w][lane + 32 * i] = pz[i];
      vs[w][lane + 32 * i] = pv[i];
    }
    __syncwarp();
    if (t0 + frames < T) load(t0 + frames);  // the next stage in flight while this one runs
    const int n = T - t0 < frames ? T - t0 : frames;
    for (int f = 0; f < n; ++f) {
      float zk[KC], d[KC], c[KC];
      unsigned vmask = 0;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        zk[k] = k < K ? zs[w][f * K + k] : 0.0f;
        vmask |= (k < K && vs[w][f * K + k] != 0) ? 1u << k : 0u;
      }
      // the prediction, the wrapped differences and the gated cost of this thread's slot
      const float pred = wrap(__fadd_rn(th, om));
      const bool live = slot && (in == 1 || in == 2);
      const float gate = in == 2 ? a.gate : a.pi;
#pragma unroll
      for (int k = 0; k < KC; ++k) {  // every column's wrap (zk = 0 past K): no branch between them
        d[k] = wrap(__fsub_rn(zk[k], pred));
        const float dist = fabsf(d[k]);
        c[k] = (live && ((vmask >> k) & 1u) && dist <= gate) ? dist : inf;
      }
      // the greedy global-minimum assignment: a round's minimum over the warp, on a tie the least m·K + k
      int assign = -1;
      unsigned taken = 0;
      const int rounds = M < K ? M : K;
      for (int r = 0; r < rounds; ++r) {
        float rc = inf;
        int rk = 0;
#pragma unroll
        for (int k = 0; k < KC; ++k)
          if (c[k] < rc) {  // the row's first minimum: strict <
            rc = c[k];
            rk = k;
          }
        // the cost is non-negative or inf (|.| and no NaN), so its bits order as its values
        const unsigned bits = __float_as_uint(rc);
        const unsigned best = __reduce_min_sync(FULL, bits);
        if (best == INF_BITS) break;  // every later round of the plain loop changes nothing
        // lane·KC + k orders as m·K + k (k < K <= KC), and KC is a power of two
        const unsigned idx = __reduce_min_sync(FULL, bits == best ? (unsigned)(lane * KC + rk) : FULL);
        const int bm = (int)idx / KC, bk = (int)idx % KC;
        taken |= 1u << bk;
        if (lane == bm) assign = bk;
#pragma unroll
        for (int k = 0; k < KC; ++k)
          if (lane == bm || k == bk) c[k] = inf;
      }
      // updates, bootstraps and deaths: one wrap on the selected argument
      const bool tracking = in == 2, booting = in == 1, has = assign >= 0;
      float za = 0.0f, da = 0.0f;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (k == assign) {
          za = zk[k];
          da = d[k];  // wrap(z_k - pred), as the plain update computes it again
        }
      const float wv = wrap(booting ? __fsub_rn(za, th) : __fadd_rn(pred, __fmul_rn(a.alpha, da)));
      if (tracking && has) {
        th = wv;
        om = __fadd_rn(om, __fmul_rn(a.beta, da));
        mi = 0;
        hi = inc(hi);
      } else if (tracking) {
        th = pred;
        mi = inc(mi);
        if (mi > a.max_misses) in = hi = mi = 0;
      } else if (booting && has) {
        om = wv;
        th = za;
        hi = inc(hi);
        mi = 0;
        in = 2;
      } else if (booting) {
        in = hi = mi = 0;
      }
      // leftover valid measurements, in order, each in the first empty slot: the r-th to the r-th
      const unsigned left = vmask & ~taken;
      if (left) {
        const bool empty = slot && in == 0;
        const unsigned free = __ballot_sync(FULL, empty);
        if (empty) {
          unsigned s = left;
          for (int r = __popc(free & ((1u << lane) - 1u)); r > 0 && s; --r) s &= s - 1u;
          if (s) {
            const int ks = __ffs(s) - 1;
            float zsp = 0.0f;
#pragma unroll
            for (int k = 0; k < KC; ++k)
              if (k == ks) zsp = zk[k];
            th = zsp;
            om = 0.0f;
            mi = hi = 0;
            in = 1;
          }
        }
      }
      if (slot) {
        const long long o = ((long long)(t0 + f) * a.L + j) * M + lane;
        a.theta[o] = th;
        a.confirmed[o] = (in == 2 && hi >= a.confirm_hits) ? 1 : 0;
      }
    }
  }
}

// ---- the wrap's latency and its bits
// wrap forms: 0 atan2f(sinf(x), cosf(x)) (the plain loops' three PyTorch ops), 1 atan2f of sincosf's pair (the
// kernels' wrap); the chain alone of 2 sinf, 3 cosf, 4 atan2f(x, 0.5)
template <int MODE>
__device__ __forceinline__ float wrap_form(float x) {
  if (MODE == 0) return atan2f(sinf(x), cosf(x));
  if (MODE == 1) return wrap(x);
  if (MODE == 2) return sinf(x);
  if (MODE == 3) return cosf(x);
  return atan2f(x, 0.5f);
}

// one thread: x = form(x + c), n times, between two clock64 reads
template <int MODE>
__global__ void wrap_chain_kernel(float x0, float c, int n, float* out, long long* cycles) {
  float x = x0;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = wrap_form<MODE>(__fadd_rn(x, c));
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

template <int MODE>
__global__ void wrap_apply_kernel(const float* x, float* y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x)
    y[i] = wrap_form<MODE>(x[i]);
}

}  // namespace

extern "C" {

// the constants ops/cuda/track_kernel.py mirrors: THREADS, M_MAX, K_MAX
void hm_track_constants(int* out) {
  out[0] = THREADS;
  out[1] = M_MAX;
  out[2] = K_MAX;
}

// z, theta: (T, L) float32, contiguous.  alpha, beta, gate: float32 (the
// plain version's Python scalars rounded as PyTorch rounds them).  T >= 1,
// L >= 1.
int hm_track_angles(const float* z, float* theta, int T, int L, int max_misses, float alpha, float beta, float gate,
                    void* stream) {
  if (T < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const TrackArgs a{z, theta, T, L, max_misses, alpha, beta, gate};
  track_angles_kernel<<<(L + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// z (T, L, K) float32 and valid (T, L, K) uint8 (0 / 1); theta (T, L, M)
// float32 and confirmed (T, L, M) uint8 (torch.bool): contiguous.  alpha,
// beta, gate, pi: float32.  T >= 1, L >= 1, 1 <= M <= M_MAX, 1 <= K <= K_MAX.
int hm_track_multi(const float* z, const unsigned char* valid, float* theta, unsigned char* confirmed, int T, int L,
                   int M, int K, int max_misses, int confirm_hits, float alpha, float beta, float gate, float pi,
                   void* stream) {
  if (T < 1 || L < 1 || M < 1 || M > M_MAX || K < 1 || K > K_MAX) return (int)cudaErrorInvalidValue;
  const MultiArgs a{z, valid, theta, confirmed, T, L, M, K, max_misses, confirm_hits, alpha, beta, gate, pi};
  const dim3 grid((L + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 2)
    track_multi_kernel<2><<<grid, THREADS, 0, s>>>(a);
  else if (K <= 4)
    track_multi_kernel<4><<<grid, THREADS, 0, s>>>(a);
  else if (K <= 8)
    track_multi_kernel<8><<<grid, THREADS, 0, s>>>(a);
  else
    track_multi_kernel<K_MAX><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// one thread's chain of n wrap forms (mode 0-4, wrap_form) from x0 with c added each step: the last value in
// out[0], the clock64 cycles of the chain in cycles[0]
int hm_wrap_chain(float x0, float c, int n, int mode, float* out, long long* cycles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: wrap_chain_kernel<0><<<1, 1, 0, s>>>(x0, c, n, out, cycles); break;
    case 1: wrap_chain_kernel<1><<<1, 1, 0, s>>>(x0, c, n, out, cycles); break;
    case 2: wrap_chain_kernel<2><<<1, 1, 0, s>>>(x0, c, n, out, cycles); break;
    case 3: wrap_chain_kernel<3><<<1, 1, 0, s>>>(x0, c, n, out, cycles); break;
    case 4: wrap_chain_kernel<4><<<1, 1, 0, s>>>(x0, c, n, out, cycles); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y = wrap form mode 0 or 1 of x, n float32 values
int hm_wrap_apply(const float* x, float* y, long long n, int mode, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    wrap_apply_kernel<0><<<blocks, 256, 0, s>>>(x, y, n);
  else if (mode == 1)
    wrap_apply_kernel<1><<<blocks, 256, 0, s>>>(x, y, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
