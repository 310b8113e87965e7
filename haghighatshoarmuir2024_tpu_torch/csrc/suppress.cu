// Fused bipolar RZCC spike extraction and greedy distance suppression for
// Hopper (sm_90a): kernels K1, K2 and K7.
//
// Replaces the Pallas kernels of haghighatshoarmuir2024_tpu/ops/pallas/
// suppress_kernel.py:
//   K1 rzcc_k1  <- _round_kernel_bipolar_first (:334): bounded-plateau maxima
//                  and minima of +-cs, then suppression round 1 of both
//                  polarities, all in shared memory; reads only cs.
//   K2 rzcc_k2  <- _round_kernel_bipolar (:248): one suppression round of both
//                  polarities given the active masks.  Its first launch is the
//                  TPU kernel's fused round 2 (:467-481); the caller repeats it
//                  until every per-tile flag is 0 (:537-547).
//   K7 suppress_k7 <- _round_kernel (:124): one suppression round of one
//                  polarity with the heights as their own input (the public
//                  op select_by_distance_tm, :687); K2's body with the
//                  negative plane compiled out, repeated by the caller until
//                  every flag is 0 (:235-245).
//
// Semantics (ops/peaks.py of either package): d = sign(cs[t+1] - cs[t]);
// the nearest boundary within W before t and at/after t decides rise/fall;
// an extremum is the plateau midpoint (l + r) >> 1.  A round: a candidate is
// a window-max if its height equals the max of the active heights in
// [t-w, t+w]; among window-maxima the rightmost wins (no window-max strictly
// to its right within w); winners are kept and clear their window.  Heights
// of the negative polarity are -cs.  Heights at candidates are finite (the
// wrappers reject others).
//
// Layout: time-major (T, R), R contiguous.  A block owns RB = 32 rows (one
// warp across neighbouring rows, so every global access is coalesced) and a
// TB-sample time tile, staged with an M-sample halo on both sides.  M is the
// correctness bound of the TPU kernel (_margin, :96-102): each pass reaches
// w samples and the extrema W + 1, so everything past M cannot change the
// tile's own outputs.  Out-of-range positions (< 0, >= T) are masked by
// global index.
//
// What bounds it on the card: shared-memory traffic.  Each pass reads O(w)
// neighbours per sample from shared memory (no doubling trick yet); device
// memory is touched once per input and output byte.  Shared memory per block
// is (TB + 2M) * RB * 7 bytes, which also limits the occupancy.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RB = 32;  // rows per block: threadIdx.x
constexpr int TY = 8;   // warps per block, strided over time: threadIdx.y

constexpr uint8_t ACT_P = 1, KEPT_P = 2, ACT_N = 4, KEPT_N = 8;
constexpr uint8_t RISE = 1, FALL = 2;

struct Tile {
  float* h;    // (TBe, RB) cs
  uint8_t* f;  // (TBe, RB) ACT/KEPT bits of both polarities
  uint8_t* a;  // (TBe, RB) scratch: boundary codes, then window-maxima
  uint8_t* b;  // (TBe, RB) scratch: winners
  int TBe;
};

__device__ Tile carve(unsigned char* smem, int TBe) {
  Tile s;
  s.h = reinterpret_cast<float*>(smem);
  s.f = smem + sizeof(float) * TBe * RB;
  s.a = s.f + TBe * RB;
  s.b = s.a + TBe * RB;
  s.TBe = TBe;
  return s;
}

// One suppression round of one polarity; ends synchronised.
__device__ void suppression_round(const Tile& s, int w, float sign, uint8_t ACT, uint8_t KEPT) {
  const int tx = threadIdx.x;
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    uint8_t top = 0;
    if (s.f[t * RB + tx] & ACT) {
      const float h = sign * s.h[t * RB + tx];
      float m = -INFINITY;
      const int lo = max(0, t - w), hi = min(s.TBe - 1, t + w);
      for (int j = lo; j <= hi; ++j)
        if (s.f[j * RB + tx] & ACT) m = fmaxf(m, sign * s.h[j * RB + tx]);
      top = (h == m) && isfinite(h);
    }
    s.a[t * RB + tx] = top;
  }
  __syncthreads();
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    uint8_t win = s.a[t * RB + tx];
    const int hi = min(s.TBe - 1, t + w);
    for (int j = t + 1; win && j <= hi; ++j)
      if (s.a[j * RB + tx]) win = 0;
    s.b[t * RB + tx] = win;
  }
  __syncthreads();
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    uint8_t f = s.f[t * RB + tx];
    if (f & ACT) {
      const int lo = max(0, t - w), hi = min(s.TBe - 1, t + w);
      for (int j = lo; j <= hi; ++j)
        if (s.b[j * RB + tx]) {
          f &= ~ACT;
          break;
        }
    }
    if (s.b[t * RB + tx]) f |= KEPT;
    s.f[t * RB + tx] = f;
  }
  __syncthreads();
}

__global__ void rzcc_k1_kernel(const float* __restrict__ cs, uint8_t* __restrict__ act_p,
                               uint8_t* __restrict__ act_n, uint8_t* __restrict__ kept_p,
                               uint8_t* __restrict__ kept_n, int T, int R, int w, int W, int M,
                               int TB) {
  extern __shared__ unsigned char smem[];
  const Tile s = carve(smem, TB + 2 * M);
  const int tx = threadIdx.x;
  const int r = blockIdx.x * RB + tx;
  const long long base = (long long)blockIdx.y * TB - M;  // global time of local 0

  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    const long long g = base + t;
    s.h[t * RB + tx] = (g >= 0 && g < T && r < R) ? cs[g * R + r] : 0.0f;
  }
  __syncthreads();

  // boundary codes: sign of the next difference, valid where both samples are
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    const long long g = base + t;
    uint8_t code = 0;
    if (g >= 0 && g < T - 1 && t < s.TBe - 1) {
      const float d = s.h[(t + 1) * RB + tx] - s.h[t * RB + tx];
      code = d > 0.0f ? RISE : (d < 0.0f ? FALL : 0);
    }
    s.a[t * RB + tx] = code;
  }
  __syncthreads();

  // bounded-plateau extrema: the nearest boundary in [t-W, t-1] and in
  // [t, t+W-1] (the max/min of the encoded indices 2i+rise)
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    int jl = -1, jr = -1;
    for (int j = t - 1; j >= max(0, t - W); --j)
      if (s.a[j * RB + tx]) {
        jl = j;
        break;
      }
    for (int j = t; j <= min(s.TBe - 1, t + W - 1); ++j)
      if (s.a[j * RB + tx]) {
        jr = j;
        break;
      }
    uint8_t f = 0;
    if (jl >= 0 && jr >= 0) {
      const long long l = base + jl + 1, rr = base + jr;
      if (base + t == ((l + rr) >> 1)) {
        const uint8_t cl = s.a[jl * RB + tx], cr = s.a[jr * RB + tx];
        if (cl == RISE && cr == FALL) f = ACT_P;
        if (cl == FALL && cr == RISE) f = ACT_N;
      }
    }
    s.f[t * RB + tx] = f;
  }
  __syncthreads();

  suppression_round(s, w, 1.0f, ACT_P, KEPT_P);
  suppression_round(s, w, -1.0f, ACT_N, KEPT_N);

  for (int t = M + threadIdx.y; t < M + TB; t += TY) {
    const long long g = base + t;
    if (g < T && r < R) {
      const uint8_t f = s.f[t * RB + tx];
      act_p[g * R + r] = (f & ACT_P) != 0;
      act_n[g * R + r] = (f & ACT_N) != 0;
      kept_p[g * R + r] = (f & KEPT_P) != 0;
      kept_n[g * R + r] = (f & KEPT_N) != 0;
    }
  }
}

// One suppression round per polarity given the active masks, at most one
// launch per round: the body of K2 (both polarities, heights +-cs) and K7
// (one polarity, heights as given).  Tiles with no candidate within their
// halo exit after reading the masks.  kept is updated in place: only this
// tile reads or writes its centre.
template <bool BIPOLAR>
__device__ __forceinline__ void round_body(const float* __restrict__ h,
                                           const uint8_t* __restrict__ act_p_in,
                                           const uint8_t* __restrict__ act_n_in,
                                           uint8_t* __restrict__ act_p_out,
                                           uint8_t* __restrict__ act_n_out,
                                           uint8_t* __restrict__ kept_p,
                                           uint8_t* __restrict__ kept_n, int* __restrict__ flags,
                                           int T, int R, int w, int M, int TB) {
  extern __shared__ unsigned char smem[];
  const Tile s = carve(smem, TB + 2 * M);
  const int tx = threadIdx.x;
  const int r = blockIdx.x * RB + tx;
  const long long base = (long long)blockIdx.y * TB - M;
  const int flag_idx = blockIdx.y * gridDim.x + blockIdx.x;

  int any = 0;
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    const long long g = base + t;
    uint8_t f = 0;
    if (g >= 0 && g < T && r < R)
      f = (act_p_in[g * R + r] ? ACT_P : 0) | ((BIPOLAR && act_n_in[g * R + r]) ? ACT_N : 0);
    s.f[t * RB + tx] = f;
    any |= f;
  }
  if (!__syncthreads_or(any)) {
    // no candidate can reach this tile: the round changes nothing here
    for (int t = M + threadIdx.y; t < M + TB; t += TY) {
      const long long g = base + t;
      if (g < T && r < R) {
        act_p_out[g * R + r] = 0;
        if (BIPOLAR) act_n_out[g * R + r] = 0;
      }
    }
    if (tx == 0 && threadIdx.y == 0) flags[flag_idx] = 0;
    return;
  }
  for (int t = threadIdx.y; t < s.TBe; t += TY) {
    const long long g = base + t;
    s.h[t * RB + tx] = (g >= 0 && g < T && r < R) ? h[g * R + r] : 0.0f;
  }
  __syncthreads();

  suppression_round(s, w, 1.0f, ACT_P, KEPT_P);
  if (BIPOLAR) suppression_round(s, w, -1.0f, ACT_N, KEPT_N);

  int remaining = 0;
  for (int t = M + threadIdx.y; t < M + TB; t += TY) {
    const long long g = base + t;
    if (g < T && r < R) {
      const uint8_t f = s.f[t * RB + tx];
      act_p_out[g * R + r] = (f & ACT_P) != 0;
      if (BIPOLAR) act_n_out[g * R + r] = (f & ACT_N) != 0;
      if (f & KEPT_P) kept_p[g * R + r] = 1;
      if (BIPOLAR && (f & KEPT_N)) kept_n[g * R + r] = 1;
      remaining |= f & (ACT_P | ACT_N);
    }
  }
  remaining = __syncthreads_or(remaining);
  if (tx == 0 && threadIdx.y == 0) flags[flag_idx] = remaining != 0;
}

__global__ void rzcc_k2_kernel(const float* __restrict__ cs, const uint8_t* __restrict__ act_p_in,
                               const uint8_t* __restrict__ act_n_in, uint8_t* __restrict__ act_p_out,
                               uint8_t* __restrict__ act_n_out, uint8_t* __restrict__ kept_p,
                               uint8_t* __restrict__ kept_n, int* __restrict__ flags, int T, int R,
                               int w, int M, int TB) {
  round_body<true>(cs, act_p_in, act_n_in, act_p_out, act_n_out, kept_p, kept_n, flags, T, R, w, M,
                   TB);
}

__global__ void suppress_k7_kernel(const float* __restrict__ height,
                                   const uint8_t* __restrict__ act_in, uint8_t* __restrict__ act_out,
                                   uint8_t* __restrict__ kept, int* __restrict__ flags, int T, int R,
                                   int w, int M, int TB) {
  round_body<false>(height, act_in, nullptr, act_out, nullptr, kept, nullptr, flags, T, R, w, M, TB);
}

size_t smem_bytes(int TB, int M) { return (size_t)(TB + 2 * M) * RB * (sizeof(float) + 3); }

}  // namespace

extern "C" {

// Shared memory a launch of any of the three kernels needs, for the wrapper's checks.
size_t hm_rzcc_smem_bytes(int TB, int M) { return smem_bytes(TB, M); }

int hm_rzcc_rows_per_block() { return RB; }

int hm_rzcc_k1(const float* cs, uint8_t* act_p, uint8_t* act_n, uint8_t* kept_p, uint8_t* kept_n,
               int T, int R, int w, int W, int M, int TB, void* stream) {
  const size_t smem = smem_bytes(TB, M);
  cudaError_t err = cudaFuncSetAttribute(rzcc_k1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + RB - 1) / RB, (T + TB - 1) / TB);
  rzcc_k1_kernel<<<grid, dim3(RB, TY), smem, (cudaStream_t)stream>>>(
      cs, act_p, act_n, kept_p, kept_n, T, R, w, W, M, TB);
  return (int)cudaGetLastError();
}

int hm_rzcc_k2(const float* cs, const uint8_t* act_p_in, const uint8_t* act_n_in,
               uint8_t* act_p_out, uint8_t* act_n_out, uint8_t* kept_p, uint8_t* kept_n,
               int* flags, int T, int R, int w, int M, int TB, void* stream) {
  const size_t smem = smem_bytes(TB, M);
  cudaError_t err = cudaFuncSetAttribute(rzcc_k2_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + RB - 1) / RB, (T + TB - 1) / TB);
  rzcc_k2_kernel<<<grid, dim3(RB, TY), smem, (cudaStream_t)stream>>>(
      cs, act_p_in, act_n_in, act_p_out, act_n_out, kept_p, kept_n, flags, T, R, w, M, TB);
  return (int)cudaGetLastError();
}

int hm_suppress_k7(const float* height, const uint8_t* act_in, uint8_t* act_out, uint8_t* kept,
                   int* flags, int T, int R, int w, int M, int TB, void* stream) {
  const size_t smem = smem_bytes(TB, M);
  cudaError_t err = cudaFuncSetAttribute(suppress_k7_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + RB - 1) / RB, (T + TB - 1) / TB);
  suppress_k7_kernel<<<grid, dim3(RB, TY), smem, (cudaStream_t)stream>>>(height, act_in, act_out,
                                                                          kept, flags, T, R, w, M, TB);
  return (int)cudaGetLastError();
}

const char* hm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
