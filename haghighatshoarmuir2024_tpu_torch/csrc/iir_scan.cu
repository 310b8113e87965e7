// The per-sample IIR scan for Hopper (sm_90a): lfilter(b, a, x) along time
// as the sequential transposed-DF2 recurrence, one launch for all T steps,
// of ops/iir.iir_scan (JAX iir_filter(method="scan"), ops/iir.py:256-281).
//
// Replaces no TPU kernel: the JAX package runs this recurrence as one
// jax.lax.scan, and the port's plain version (ops/iir.iir_scan_plain) is a
// Python loop of four tensor ops a sample, host-bound on the card.  One
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
// operations a step (y's add, a_1*y, the difference, s_2's add: 16 cycles),
// T times; the bytes (x in, y out) and the 2 + 4N operations a lane a step
// are far below that at every shape the port runs, but a warp issues one
// instruction a cycle, so the chain's step is reached only if the lane's
// thread issues little besides its 2 + 4N operations.  What the design does
// about it: a block is two warps on two schedulers, a consumer warp of 32
// lanes and a producer warp that does every global access.  x arrives in a
// ring of STAGES tiles of TS steps in shared memory, STAGES - 1 tiles ahead
// of the consumer, by cp.async (16-byte copies of whole rows where the
// lanes lie flat and aligned, a 4-byte copy a lane a step otherwise, as in
// MUSIC's strided view).  The consumer's step is one shared load, its
// 2 + 4N operations and one shared store of y over the x it read; the
// producer drains a finished tile's y to global memory (16-byte or 4-byte
// stores, the same test) and refills the slot.  Named barriers hand a slot
// over, one pair a tile (FULL: x landed; EMPTY: y written).  Addresses are
// computed once a tile.  One consumer warp a block spreads the chains over
// the SMs, each on a scheduler of its own.
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
constexpr int STAGES = 4;    // tiles in the ring
constexpr int LANES = 32;    // lanes a block: one consumer warp
constexpr int THREADS = 2 * LANES;  // the consumer warp and the producer warp
constexpr int VEC = 4;       // floats a 16-byte copy
constexpr int ROWS_A_COPY = LANES / (LANES / VEC);  // rows of a tile one 16-byte copy instruction covers: 4
constexpr int FULL = 1, EMPTY = 1 + STAGES;  // named barriers FULL + slot, EMPTY + slot (0 is __syncthreads')

struct Coef {
  float b0;
  float b[N_MAX];  // b_1 .. b_N
  float a[N_MAX];  // a_1 .. a_N
};

struct Layout {
  long long T;
  int L, comps, D2;
  long long xs0, xs1, xs2, ys0, ys1, ys2;
  int vec_x, vec_y;  // the lanes lie flat, 16-byte aligned rows: 16-byte copies
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// both warps take part in every named barrier: the consumer waits, the producer only arrives, or the reverse
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

template <int N>
__device__ __forceinline__ float step(float xv, float (&s)[N + 1], const Coef& cf) {
  const float yv = __fadd_rn(__fmul_rn(cf.b0, xv), s[0]);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __fadd_rn(__fsub_rn(__fmul_rn(cf.b[i], xv), __fmul_rn(cf.a[i], yv)), s[i + 1]);
  return yv;
}

// warp 0: the lanes' recurrence, reading x from and writing y to the ring
template <int N>
__device__ __forceinline__ void consume(float (*ring)[TS][LANES], const float* __restrict__ zi, float* __restrict__ zf,
                        const Coef& cf, const Layout& lay, long long tiles) {
  const int lane = threadIdx.x;
  const int j = blockIdx.x * LANES + lane;
  const bool live = j < lay.L;  // an idle lane computes on what the ring holds and stores nothing
  const int c = j % lay.comps, r = j / lay.comps;
  float s[N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = (live && zi) ? zi[((long long)r * N + i) * lay.comps + c] : 0.0f;
  s[N] = 0.0f;
  for (long long tile = 0; tile < tiles; ++tile) {
    const int slot = (int)(tile % STAGES);
    float* v = &ring[slot][0][lane];
    bar_sync(FULL + slot);
    if ((tile + 1) * TS <= lay.T) {
#pragma unroll 16
      for (int k = 0; k < TS; ++k) v[k * LANES] = step<N>(v[k * LANES], s, cf);
    } else {
      const int n = (int)(lay.T - tile * TS);
      for (int k = 0; k < n; ++k) v[k * LANES] = step<N>(v[k * LANES], s, cf);
    }
    __threadfence_block();
    bar_arrive(EMPTY + slot);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i) zf[((long long)r * N + i) * lay.comps + c] = s[i];
  }
}

// warp 1: every global access of x and y, a tile at a time
__device__ __forceinline__ void produce(float (*ring)[TS][LANES], const float* __restrict__ x, float* __restrict__ y,
                        const Layout& lay, long long tiles) {
  const int p = threadIdx.x - LANES;
  const int lane0 = blockIdx.x * LANES;
  // the 4-byte path: thread p carries lane lane0 + p
  const int j = lane0 + p;
  const bool live = j < lay.L;
  const int c = j % lay.comps, r = j / lay.comps;
  const int i1 = r / lay.D2, i2 = r % lay.D2;
  const float* xp = x + i1 * lay.xs1 + i2 * lay.xs2 + c;
  float* yp = y + i1 * lay.ys1 + i2 * lay.ys2 + c;
  // the 16-byte path: thread p moves vector p % 8 of rows p / 8, p / 8 + 4, ...
  const int vcol = (p % (LANES / VEC)) * VEC, vrow = p / (LANES / VEC);
  const bool vlive = lane0 + vcol < lay.L;  // the vector path takes L % 4 == 0: a vector is whole or absent

  auto rows = [&](long long tile) { return (int)min((long long)TS, lay.T - tile * TS); };
  auto issue = [&](long long tile) {
    if (tile < tiles) {
      const int slot = (int)(tile % STAGES), n = rows(tile);
      const long long t0 = tile * TS;
      if (lay.vec_x) {
        if (vlive) {
          const float* src = x + (t0 + vrow) * lay.xs0 + lane0 + vcol;
#pragma unroll 8
          for (int k = vrow; k < n; k += ROWS_A_COPY, src += ROWS_A_COPY * lay.xs0)
            cp_async16(&ring[slot][k][vcol], src);
        }
      } else if (live) {
        const float* src = xp + t0 * lay.xs0;
#pragma unroll 16
        for (int k = 0; k < n; ++k, src += lay.xs0) cp_async4(&ring[slot][k][p], src);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups in flight fixed
  };
  auto drain = [&](long long tile) {
    const int slot = (int)(tile % STAGES), n = rows(tile);
    const long long t0 = tile * TS;
    if (lay.vec_y) {
      if (vlive) {
        float* dst = y + (t0 + vrow) * lay.ys0 + lane0 + vcol;
#pragma unroll 8
        for (int k = vrow; k < n; k += ROWS_A_COPY, dst += ROWS_A_COPY * lay.ys0)
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&ring[slot][k][vcol]);
      }
    } else if (live) {
      float* dst = yp + t0 * lay.ys0;
#pragma unroll 16
      for (int k = 0; k < n; ++k, dst += lay.ys0) *dst = ring[slot][k][p];
    }
  };

#pragma unroll
  for (int k = 0; k < STAGES; ++k) issue(k);
  cp_async_wait<STAGES - 1>();  // tile 0 has landed
  __threadfence_block();
  __syncwarp();
  bar_arrive(FULL);
  for (long long tile = 0; tile < tiles; ++tile) {
    const int slot = (int)(tile % STAGES);
    if (tile + 1 < tiles) {  // publish the next tile before waiting on this one
      cp_async_wait<STAGES - 2>();
      __threadfence_block();
      __syncwarp();
      bar_arrive(FULL + (int)((tile + 1) % STAGES));
    }
    bar_sync(EMPTY + slot);  // the consumer has written this tile's y
    drain(tile);
    __syncwarp();  // every thread's reads of the slot come before any copy into it
    issue(tile + STAGES);
  }
  cp_async_wait<0>();
}

template <int N>
__global__ void __launch_bounds__(THREADS) iir_scan_kernel(const float* __restrict__ x,
                                                           const float* __restrict__ zi, float* __restrict__ y,
                                                           float* __restrict__ zf, const Coef cf, const Layout lay) {
  __shared__ __align__(16) float ring[STAGES][TS][LANES];
  const long long tiles = (lay.T + TS - 1) / TS;
  if (threadIdx.x < LANES)
    consume<N>(ring, zi, zf, cf, lay, tiles);
  else
    produce(ring, x, y, lay, tiles);
}

template <int N>
int launch(const float* x, const float* zi, float* y, float* zf, const Coef& cf, const Layout& lay,
           cudaStream_t st) {
  const int blocks = (lay.L + LANES - 1) / LANES;
  iir_scan_kernel<N><<<blocks, THREADS, 0, st>>>(x, zi, y, zf, cf, lay);
  return (int)cudaGetLastError();
}

// a 16-byte copy path's layout (hm_iir_scan's vec_x / vec_y): 0, or the error that refuses it
int vector_layout_error(const float* p, int L, int comps, int D2, long long s0, long long s1, long long s2) {
  const int D1 = L / comps / D2;
  if ((D1 != 1 && s1 != (long long)D2 * comps) || (D2 != 1 && s2 != comps)) return (int)cudaErrorInvalidValue;
  if (L % VEC || s0 % VEC || (size_t)p % (sizeof(float) * VEC)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

extern "C" {

// the constants ops/cuda/iir_kernel.py mirrors: N_MAX, LANES, TS, VEC
void hm_iir_scan_constants(int* out) {
  out[0] = N_MAX;
  out[1] = LANES;
  out[2] = TS;
  out[3] = VEC;
}

// x, y: float32 lanes by the strides above; zi (may be null: zeros) and zf:
// (L / comps, N, comps) float32 contiguous; coef: host float32 b0, b_1..b_N,
// a_1..a_N (2N + 1 values).  T >= 1, L >= 1, comps 1 or 2, 0 <= N <= 8.
// vec_x / vec_y: x's / y's lanes lie flat (lane j at float j of its step's
// row), L, the step stride and the base 16-byte aligned
// (ops/cuda/iir_kernel.vector_rows); checked here too, before any 16-byte
// copy or store.
int hm_iir_scan(const float* x, const float* zi, float* y, float* zf, const float* coef, int N, long long T, int L,
                int comps, int D2, long long xs0, long long xs1, long long xs2, long long ys0, long long ys1,
                long long ys2, int vec_x, int vec_y, void* stream) {
  if (N < 0 || N > N_MAX || T < 1 || L < 1 || (comps != 1 && comps != 2) || D2 < 1 || L % comps)
    return (int)cudaErrorInvalidValue;
  if (vec_x)
    if (const int e = vector_layout_error(x, L, comps, D2, xs0, xs1, xs2)) return e;
  if (vec_y)
    if (const int e = vector_layout_error(y, L, comps, D2, ys0, ys1, ys2)) return e;
  Coef cf{};
  cf.b0 = coef[0];
  for (int i = 0; i < N; ++i) {
    cf.b[i] = coef[1 + i];
    cf.a[i] = coef[1 + N + i];
  }
  const Layout lay{T, L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2, vec_x, vec_y};
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
