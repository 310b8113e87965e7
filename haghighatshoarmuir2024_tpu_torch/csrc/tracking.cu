// The two DoA trackers on the circle for Hopper (sm_90a): utils/tracking.py's
// track_angles and track_multi_angles over all T frames in one launch each
// (JAX track_angles, utils/tracking.py:155, and track_multi_angles, :400:
// one jax.lax.scan each).
//
// Replace no TPU kernel: the JAX package runs both trackers as lax.scans, and
// the port's plain versions (track_angles_plain, track_multi_angles_plain)
// are Python loops of tensor ops a frame (about 60 for the alpha-beta step,
// a few hundred for the multi-target step), host-bound on the card.  A thread
// carries one lane (one sequence of the batch) through every frame, its
// state in registers (the multi-target slots and cost in local memory).
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
// there).  The plain versions' Python scalars reach PyTorch's kernels as
// float32: alpha, beta and gate (a float32 tensor compared with a Python
// float compares with the float rounded to float32), and the multi-target
// gates gate and pi (a float32 tensor from torch.where); the wrapper rounds
// them and passes float32.  Every sum, difference and product is rounded on
// its own (__fadd_rn, __fsub_rn, __fmul_rn: nothing contracts into an FMA),
// so every output equals the plain loop's bit for bit.
//
// What bounds them on the card: the frame's dependent chain, three wraps in
// a row for the alpha-beta step (the prediction, the innovation, the
// update), a few more for the multi-target step (and its assignment rounds);
// the bytes and the lanes are far too few to matter at every shape the port
// runs (240 frames x 96 lanes).  What the design does about it: nothing
// beyond a thread a lane and the next frame's measurements read before the
// current frame's chain; a simple kernel that is right.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // lanes a block
constexpr int M_MAX = 16;     // track slots a lane
constexpr int K_MAX = 16;     // measurements a frame

__device__ __forceinline__ float wrap(float x) { return atan2f(sinf(x), cosf(x)); }

// PyTorch's int32 + 1 wraps around; signed overflow in C++ does not
__device__ __forceinline__ int inc(int v) { return (int)((unsigned)v + 1u); }

struct TrackArgs {
  const float* z;  // (T, L)
  float* theta;    // (T, L)
  int T, L, max_misses;
  float alpha, beta, gate;
};

__global__ void __launch_bounds__(THREADS) track_angles_kernel(const TrackArgs a) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= a.L) return;
  float theta = 0.0f, omega = 0.0f;
  int misses = 0, init = 0;
  const float* __restrict__ zp = a.z + j;
  float* __restrict__ out = a.theta + j;
  float znext = zp[0];
  for (int t = 0; t < a.T; ++t) {
    const float z = znext;
    if (t + 1 < a.T) znext = zp[(long long)(t + 1) * a.L];
    if (init == 0) {
      theta = z;
      omega = 0.0f;
      misses = 0;
      init = 1;
    } else if (init == 1) {
      omega = wrap(__fsub_rn(z, theta));
      theta = z;
      misses = 0;
      init = 2;
    } else {
      const float pred = wrap(__fadd_rn(theta, omega));
      const float delta = wrap(__fsub_rn(z, pred));
      const bool inlier = fabsf(delta) <= a.gate;
      const int m = inlier ? 0 : inc(misses);
      if (m > a.max_misses) {
        theta = z;
        omega = 0.0f;
        misses = 0;
        init = 1;
      } else if (inlier) {
        theta = wrap(__fadd_rn(pred, __fmul_rn(a.alpha, delta)));
        omega = __fadd_rn(omega, __fmul_rn(a.beta, delta));
        misses = 0;
      } else {
        theta = pred;
        misses = m;
      }
    }
    out[(long long)t * a.L] = theta;
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

__global__ void __launch_bounds__(THREADS) track_multi_kernel(const MultiArgs a) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= a.L) return;
  const int M = a.M, K = a.K;
  float th[M_MAX], om[M_MAX], pred[M_MAX];
  int mi[M_MAX], in[M_MAX], hi[M_MAX], assign[M_MAX];
  float cost[M_MAX * K_MAX], d[M_MAX * K_MAX];
  float zc[K_MAX], zn[K_MAX];
  bool vc[K_MAX], vn[K_MAX], taken[K_MAX];
  for (int m = 0; m < M; ++m) {
    th[m] = 0.0f;
    om[m] = 0.0f;
    mi[m] = in[m] = hi[m] = 0;
  }
  const long long zstep = (long long)a.L * K, ostep = (long long)a.L * M;
  for (int k = 0; k < K; ++k) {
    zn[k] = a.z[(long long)j * K + k];
    vn[k] = a.valid[(long long)j * K + k] != 0;
  }
  for (int t = 0; t < a.T; ++t) {
    for (int k = 0; k < K; ++k) {
      zc[k] = zn[k];
      vc[k] = vn[k];
    }
    if (t + 1 < a.T) {
      const long long o = (t + 1) * zstep + (long long)j * K;
      for (int k = 0; k < K; ++k) {
        zn[k] = a.z[o + k];
        vn[k] = a.valid[o + k] != 0;
      }
    }
    // predictions, the wrapped differences and the gated cost
    for (int m = 0; m < M; ++m) {
      pred[m] = wrap(__fadd_rn(th[m], om[m]));
      const bool live = in[m] == 2 || in[m] == 1;
      const float gate = in[m] == 2 ? a.gate : a.pi;
      for (int k = 0; k < K; ++k) {
        const float dk = wrap(__fsub_rn(zc[k], pred[m]));
        const float dist = fabsf(dk);
        d[m * K + k] = dk;
        cost[m * K + k] = (live && vc[k] && dist <= gate) ? dist : __int_as_float(0x7f800000);
      }
    }
    // the greedy global-minimum assignment
    for (int m = 0; m < M; ++m) assign[m] = -1;
    for (int k = 0; k < K; ++k) taken[k] = false;
    const int rounds = M < K ? M : K;
    for (int r = 0; r < rounds; ++r) {
      int best = 0;
      float bc = cost[0];
      for (int i = 1; i < M * K; ++i)
        if (cost[i] < bc) {  // the first minimum: a tie keeps the earlier index
          bc = cost[i];
          best = i;
        }
      if (!(bc < __int_as_float(0x7f800000))) break;  // the cost holds no NaN: inf ends every later round
      const int bm = best / K, bk = best % K;
      assign[bm] = bk;
      taken[bk] = true;
      for (int k = 0; k < K; ++k) cost[bm * K + k] = __int_as_float(0x7f800000);
      for (int m = 0; m < M; ++m) cost[m * K + bk] = __int_as_float(0x7f800000);
    }
    // updates, bootstraps and deaths
    for (int m = 0; m < M; ++m) {
      const bool tracking = in[m] == 2, booting = in[m] == 1, has = assign[m] >= 0;
      const int k = has ? assign[m] : 0;
      if (tracking && has) {
        const float delta = d[m * K + k];  // wrap(z_k - pred_m), as the plain update computes it again
        th[m] = wrap(__fadd_rn(pred[m], __fmul_rn(a.alpha, delta)));
        om[m] = __fadd_rn(om[m], __fmul_rn(a.beta, delta));
        mi[m] = 0;
        hi[m] = inc(hi[m]);
      } else if (tracking) {
        th[m] = pred[m];
        mi[m] = inc(mi[m]);
        if (mi[m] > a.max_misses) in[m] = hi[m] = mi[m] = 0;
      } else if (booting && has) {
        om[m] = wrap(__fsub_rn(zc[k], th[m]));
        th[m] = zc[k];
        hi[m] = inc(hi[m]);
        mi[m] = 0;
        in[m] = 2;
      } else if (booting) {
        in[m] = hi[m] = mi[m] = 0;
      }
    }
    // leftover valid measurements spawn in the first empty slot, in order
    for (int k = 0; k < K; ++k) {
      if (!vc[k] || taken[k]) continue;
      int slot = -1;
      for (int m = 0; m < M; ++m)
        if (in[m] == 0) {
          slot = m;
          break;
        }
      if (slot < 0) break;  // no slot is freed within a frame
      th[slot] = zc[k];
      om[slot] = 0.0f;
      mi[slot] = hi[slot] = 0;
      in[slot] = 1;
    }
    const long long o = t * ostep + (long long)j * M;
    for (int m = 0; m < M; ++m) {
      a.theta[o + m] = th[m];
      a.confirmed[o + m] = (in[m] == 2 && hi[m] >= a.confirm_hits) ? 1 : 0;
    }
  }
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
  track_multi_kernel<<<(L + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
