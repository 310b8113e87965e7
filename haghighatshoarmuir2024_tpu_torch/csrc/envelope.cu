// The attack/release envelope follower for Hopper (sm_90a): ops/envelope.py's
// Envelope.evolve over all T samples in one launch (JAX Envelope.evolve,
// ops/envelope.py:45, one jax.lax.scan).
//
// Replaces no TPU kernel: the JAX package runs the follower as a lax.scan,
// and the port's plain version (Envelope.evolve_plain) is a Python loop of
// about ten tensor ops a sample, host-bound on the card.  One thread carries
// one lane (a column of the (T, L) signal) through every step, its state s in
// a register.  Per step, with x = |sig[t]|:
//
//   out[t - 1] = s
//   rise = x >= s                       (false for a NaN on either side)
//   s    = (1 - 1/w)·s + ((1/w)·x)·rise   w the rise window if rise, else the fall window
//
// and out[T - 1] = the final state.  The plain loop forms w as
// win_fall·(1 - rise) + win_rise·rise, which is exactly one of the two
// windows, and 1/w as reciprocal(w)·1 (PyTorch's 1 / tensor), so the two
// reciprocals and the two 1 - 1/w are computed once, here, each rounded as
// the plain loop rounds it, and selected each step.  Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn and the double ones: nothing
// contracts into an FMA), and the factor rise = 0 or 1 is multiplied in as
// the plain loop does, so a NaN or inf sample propagates as it does there:
// the lane's outputs and final state equal the plain loop's bit for bit.
//
// What bounds it on the card: the recurrence's dependent chain, T steps of
// three operations (the product c·s, the sum, the select on the compare,
// which runs beside the product); the bytes (the signal in, the envelope out)
// are below that at every shape the port runs.  What the design does about
// it: both candidates of a step (rise and fall) are computed and one is
// selected, so the compare is off the chain, and the samples are read AHEAD
// steps ahead into registers, so no load sits on it.  128 threads a block; a
// warp's 32 lanes read and write one run of 32 values a step.  On the H100 a
// step takes 64-76 cycles against the chain's 12: neither a prefetch of the
// lines ahead, nor 32 steps ahead, nor the outputs held back in registers
// shortens it (PERF.md §6); what fills it is not known.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // lanes a block
constexpr int AHEAD = 16;     // samples read ahead of the recurrence into registers

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float of(double w) { return __double2float_rn(w); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double rcp(double a) { return __ddiv_rn(1.0, a); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double of(double w) { return w; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    envelope_kernel(const T* __restrict__ x, const T* __restrict__ s0, T* __restrict__ out, T* __restrict__ s_fin,
                    double win_fall, double win_rise, long long steps, int L) {
  using R = Rn<T>;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  // the plain loop's 1/w = reciprocal(w)·1 and 1 - 1/w, for w = each window
  const T one = T(1), zero = T(0);
  const T r_fall = R::mul(R::rcp(R::of(win_fall)), one), r_rise = R::mul(R::rcp(R::of(win_rise)), one);
  const T c_fall = R::sub(one, r_fall), c_rise = R::sub(one, r_rise);
  const T* __restrict__ xp = x + j;
  T* __restrict__ op = out + j;
  T s = s0 ? s0[j] : R::abs(xp[0]);
  T cur[AHEAD], nxt[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) nxt[u] = 1 + u < steps ? xp[(1 + u) * (long long)L] : zero;
  for (long long t0 = 1; t0 < steps; t0 += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      cur[u] = nxt[u];
      const long long t = t0 + AHEAD + u;
      nxt[u] = t < steps ? xp[t * L] : zero;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const long long t = t0 + u;
      if (t >= steps) break;
      op[(t - 1) * L] = s;
      const T xv = R::abs(cur[u]);
      // both candidates, in the plain loop's order of operations; rise selects one
      const T up = R::add(R::mul(c_rise, s), R::mul(R::mul(r_rise, xv), one));
      const T down = R::add(R::mul(c_fall, s), R::mul(R::mul(r_fall, xv), zero));
      s = xv >= s ? up : down;
    }
  }
  op[(steps - 1) * L] = s;
  s_fin[j] = s;
}

template <typename T>
int launch(const void* x, const void* s0, void* out, void* s_fin, double wf, double wr, long long T_, int L,
           cudaStream_t st) {
  const int blocks = (L + THREADS - 1) / THREADS;
  envelope_kernel<T><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(s0),
                                                 static_cast<T*>(out), static_cast<T*>(s_fin), wf, wr, T_, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the constants ops/cuda/envelope_kernel.py mirrors: THREADS, AHEAD
void hm_envelope_constants(int* out) {
  out[0] = THREADS;
  out[1] = AHEAD;
}

// x (T, L) the signal, contiguous, float32 (dtype_code 0) or float64 (1);
// s0 (L,) the state before sample 1 in the same dtype, or null: |x[0]|;
// out (T, L) and s_fin (L,).  win_fall, win_rise: the windows in samples
// (Envelope.win_lens), rounded to the dtype here.  T >= 1, L >= 1.
int hm_envelope(const void* x, const void* s0, void* out, void* s_fin, double win_fall, double win_rise,
                long long T, int L, int dtype_code, void* stream) {
  if (T < 1 || L < 1 || (dtype_code != 0 && dtype_code != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype_code == 0) return launch<float>(x, s0, out, s_fin, win_fall, win_rise, T, L, st);
  return launch<double>(x, s0, out, s_fin, win_fall, win_rise, T, L, st);
}

}  // extern "C"
