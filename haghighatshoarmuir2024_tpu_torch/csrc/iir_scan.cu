// The per-sample IIR scan for Hopper (sm_90a): lfilter(b, a, x) along time
// as the sequential transposed-DF2 recurrence, one launch for all T steps,
// of ops/iir.iir_scan (JAX iir_filter(method="scan"), ops/iir.py:256-281).
//
// Replaces no TPU kernel: the JAX package runs this recurrence as one
// jax.lax.scan, and the port's plain version (ops/iir.iir_scan_plain) is a
// Python loop of four tensor ops a sample, host-bound on the card.  Here one
// thread carries one real lane (a float32 column, or the real or imaginary
// part of a complex64 one: the coefficients are real, so the two parts never
// meet) through every step, its N state values in registers:
//
//   y   = b0*x + s_1
//   s_i = (b_i*x - a_i*y) + s_{i+1}       (s_{N+1} = 0)
//
// each product, difference and sum rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: nothing contracts into an FMA), with the coefficients rounded to
// float32 as the plain version's tensors hold them, so a lane's outputs and
// final state equal the plain loop's bit for bit (up to the sign of a zero:
// the plain version multiplies a complex lane by a complex coefficient whose
// imaginary part is 0).
//
// What bounds it on the card: the recurrence's dependent chain, four float
// operations a step (y's add, a_1*y, the difference, s_2's add), T times;
// the bytes (x in, y out) and the 2 + 4N operations a lane a step are far
// below that at every shape the port runs.  What the design does about it:
// the loads stay off the chain.  A block is one warp of 32 lanes; its x
// arrives through a ring of STAGES tiles of TS steps in shared memory by
// cp.async, STAGES - 1 tiles ahead of the step being computed, so a step
// reads its sample from shared memory.  Each thread copies and reads only
// its own lane's samples, so no barrier is needed: cp.async.wait_group
// orders a thread's own copies.  y goes straight out, one store a step: a
// store does not wait.  One warp a block spreads the lanes over the SMs,
// each chain on a scheduler of its own.
//
// Layout: the lanes of x and y are given by strides (in floats), so the
// time-major views the callers pass (movedim of a batch, a complex tensor
// seen as floats) need no copy: lane j = (r, c) with c < comps the complex
// part and r = i1 * D2 + i2; x[t, lane] = x[t * xs0 + i1 * xs1 + i2 * xs2 + c].
// The state zi / zf is (R, N, comps) contiguous, as the plain version's
// (..., N) complex state seen as floats.
#include <cuda_runtime.h>

namespace {

constexpr int N_MAX = 8;     // state values a lane
constexpr int TS = 64;       // steps a tile
constexpr int STAGES = 3;    // tiles in the ring
constexpr int LANES = 32;    // one warp a block

struct Coef {
  float b0;
  float b[N_MAX];  // b_1 .. b_N
  float a[N_MAX];  // a_1 .. a_N
};

struct Layout {
  long long T;
  int L, comps, D2;
  long long xs0, xs1, xs2, ys0, ys1, ys2;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int N>
__global__ void __launch_bounds__(LANES) iir_scan_kernel(const float* __restrict__ x,
                                                         const float* __restrict__ zi, float* __restrict__ y,
                                                         float* __restrict__ zf, const Coef cf, const Layout lay) {
  __shared__ float ring[STAGES][TS][LANES];
  const int j = blockIdx.x * LANES + threadIdx.x;
  if (j >= lay.L) return;  // no barrier below: an idle lane may leave
  const int c = j % lay.comps, r = j / lay.comps;
  const int i1 = r / lay.D2, i2 = r % lay.D2;
  const float* xp = x + i1 * lay.xs1 + i2 * lay.xs2 + c;
  float* yp = y + i1 * lay.ys1 + i2 * lay.ys2 + c;
  const long long T = lay.T;

  float s[N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = zi ? zi[((long long)r * N + i) * lay.comps + c] : 0.0f;
  s[N] = 0.0f;

  const long long tiles = (T + TS - 1) / TS;
  auto issue = [&](long long tile) {
    if (tile < tiles) {
      float* dst = &ring[tile % STAGES][0][threadIdx.x];
      const long long t0 = tile * TS;
      const int n = (int)min((long long)TS, T - t0);
      const float* src = xp + t0 * lay.xs0;
      for (int k = 0; k < n; ++k) cp_async4(dst + k * LANES, src + k * lay.xs0);
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups in flight fixed
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);

  for (long long tile = 0; tile < tiles; ++tile) {
    issue(tile + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // this tile's copies have landed
    const float* xs = &ring[tile % STAGES][0][threadIdx.x];
    const long long t0 = tile * TS;
    const int n = (int)min((long long)TS, T - t0);
    float* out = yp + t0 * lay.ys0;
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float xv = xs[k * LANES];
      const float yv = __fadd_rn(__fmul_rn(cf.b0, xv), s[0]);
#pragma unroll
      for (int i = 0; i < N; ++i)
        s[i] = __fadd_rn(__fsub_rn(__fmul_rn(cf.b[i], xv), __fmul_rn(cf.a[i], yv)), s[i + 1]);
      out[k * lay.ys0] = yv;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < N; ++i) zf[((long long)r * N + i) * lay.comps + c] = s[i];
}

template <int N>
int launch(const float* x, const float* zi, float* y, float* zf, const Coef& cf, const Layout& lay,
           cudaStream_t st) {
  const int blocks = (lay.L + LANES - 1) / LANES;
  iir_scan_kernel<N><<<blocks, LANES, 0, st>>>(x, zi, y, zf, cf, lay);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hm_iir_scan_max_state() { return N_MAX; }

// x, y: float32 lanes by the strides above; zi (may be null: zeros) and zf:
// (L / comps, N, comps) float32 contiguous; coef: host float32 b0, b_1..b_N,
// a_1..a_N (2N + 1 values).  T >= 1, L >= 1, comps 1 or 2, 0 <= N <= 8.
int hm_iir_scan(const float* x, const float* zi, float* y, float* zf, const float* coef, int N, long long T, int L,
                int comps, int D2, long long xs0, long long xs1, long long xs2, long long ys0, long long ys1,
                long long ys2, void* stream) {
  if (N < 0 || N > N_MAX || T < 1 || L < 1 || (comps != 1 && comps != 2) || D2 < 1 || L % comps)
    return (int)cudaErrorInvalidValue;
  Coef cf{};
  cf.b0 = coef[0];
  for (int i = 0; i < N; ++i) {
    cf.b[i] = coef[1 + i];
    cf.a[i] = coef[1 + N + i];
  }
  const Layout lay{T, L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 0: return launch<0>(x, zi, y, zf, cf, lay, st);
    case 1: return launch<1>(x, zi, y, zf, cf, lay, st);
    case 2: return launch<2>(x, zi, y, zf, cf, lay, st);
    case 3: return launch<3>(x, zi, y, zf, cf, lay, st);
    case 4: return launch<4>(x, zi, y, zf, cf, lay, st);
    case 5: return launch<5>(x, zi, y, zf, cf, lay, st);
    case 6: return launch<6>(x, zi, y, zf, cf, lay, st);
    case 7: return launch<7>(x, zi, y, zf, cf, lay, st);
    default: return launch<8>(x, zi, y, zf, cf, lay, st);
  }
}

}  // extern "C"
