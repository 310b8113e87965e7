// The attack/release envelope follower for Hopper (sm_90a): ops/envelope.py's
// Envelope.evolve over all T samples in one launch (JAX Envelope.evolve,
// ops/envelope.py:45, one jax.lax.scan).
//
// Replaces no TPU kernel: the JAX package runs the follower as a lax.scan,
// and the port's plain version (Envelope.evolve_plain) is a Python loop of
// about ten tensor ops a sample, host-bound on the card.  One thread carries
// one lane (a column of the (T, L) signal) through every step, its state s in
// a register.  With s_0 the state given, or |x[0]|, and for t >= 1, x = |x[t]|:
//
//   rise = x >= s_{t-1}                 (false for a NaN on either side)
//   s_t  = (1 - 1/w)·s_{t-1} + ((1/w)·x)·rise   w the rise window if rise, else the fall window
//   out[t] = s_t                        (the plain loop's out[t - 1], the state before sample t;
//                                        out[T - 1] the final state)
//
// The plain loop forms w as win_fall·(1 - rise) + win_rise·rise, which is
// exactly one of the two windows, and 1/w as reciprocal(w)·1 (PyTorch's
// 1 / tensor), so the two reciprocals and the two 1 - 1/w are computed once,
// here, each rounded as the plain loop rounds it, and selected each step.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn and the
// double ones: nothing contracts into an FMA), and the factor rise = 0 or 1
// is multiplied in as the plain loop does, so a NaN or inf sample propagates
// as it does there: the lane's outputs and final state equal the plain
// loop's bit for bit.
//
// What bounds it on the card: the recurrence's dependent chain, T - 1 steps
// of the product c·s, the sum and the select on the compare, which runs
// beside the product.  Counted as three operations of 4 cycles that is 12
// cycles a step in float32 (24 in float64); as the card runs it, one warp's
// chain from registers (envelope_chain_kernel, hm_envelope_chain) takes
// 19.5 cycles a step, 29.5 in float64, and the product and sum alone took
// 8.3 (16.2): the compare's predicate costs about 11 cycles on the chain,
// and neither a select by the sign of |x| - s through integer operations
// nor the second of two steps computed from both of the first's candidates
// took it off (PERF.md §6).  The bytes (the signal in, the envelope out) are far below
// either at every shape the port runs.  The step's other work (|x|, the
// products of x, the load of x, the store of s) is off the chain, but a warp
// issues one instruction a cycle, so the chain is reached only if the lane's
// thread issues little besides its step.
//
// What filled the first design's step (a thread a lane in blocks of 128,
// each warp doing its own global loads 16 steps ahead into registers and a
// global store a step; 64-65 cycles a step on the H100 at (12 000, 7)): its
// SASS holds 34.8 instructions a step, 9 of them the step's float operations
// and 23 integer ones, the 64-bit step counters, the two bounds checks a
// step (the load's and the loop's) and the 64-bit addresses of the load and
// the store, beside the load, the store and a branch.
//
// What this design does about it (the pattern of csrc/iir_scan.cu): a block
// is two warps on two schedulers, a consumer warp of LANES lanes and a
// producer warp that does every global access.  x arrives in a ring of
// STAGES tiles of TS steps x LANES lanes in shared memory, STAGES - 1 tiles
// ahead of the consumer, by cp.async: 16-byte copies of whole rows where L
// times the item size is a multiple of 16 and the base is 16-byte aligned
// (672 lanes in float32), an item a lane a step otherwise (7 lanes: 28-byte
// rows).  The consumer's step is one shared load of x (read GROUP steps
// ahead into registers; a step is a row of LANES values, so lane j reads
// bank j), the step's operations and one shared store of s over the x it
// read: 11.4 instructions a step in its whole tiles, which run with no
// per-step check, their addresses computed once a tile and their counters
// 32-bit.  The first tile (its first step is the initial state) and the
// last, partial one take a plain loop of their own.  The producer drains a
// finished tile's states to global memory (the same two widths) and refills
// the slot.  Named barriers hand a slot over, one pair a tile (FULL: x
// landed; EMPTY: s written); they and their fences cost under half a cycle
// a step.  One consumer warp a block spreads the chains over the SMs, each
// on a scheduler of its own.  A step takes 24.4-25.1 cycles at 672 lanes and
// 28.7-28.9 at 7, whose producer copies an item a lane a step.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;           // lanes a block: one consumer warp
constexpr int THREADS = 2 * LANES;  // the consumer warp and the producer warp
constexpr int TS = 128;             // steps a tile
constexpr int STAGES = 4;           // tiles in the ring
constexpr int VEC_BYTES = 16;       // a row copy's width
constexpr int GROUP = 8;            // steps the consumer reads ahead into registers
constexpr int FULL = 1, EMPTY = 1 + STAGES;  // named barriers FULL + slot, EMPTY + slot (0 is __syncthreads')
static_assert(TS % (2 * GROUP) == 0, "a whole tile is read in pairs of groups");

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

// the plain loop's 1/w = reciprocal(w)·1 and 1 - 1/w, for w = each window
template <typename T>
struct Coef {
  T r_fall, r_rise, c_fall, c_rise;
  __device__ Coef(double win_fall, double win_rise) {
    using R = Rn<T>;
    r_fall = R::mul(R::rcp(R::of(win_fall)), T(1));
    r_rise = R::mul(R::rcp(R::of(win_rise)), T(1));
    c_fall = R::sub(T(1), r_fall);
    c_rise = R::sub(T(1), r_rise);
  }
};

// one step: both candidates, in the plain loop's order of operations; rise selects one
template <typename T>
__device__ __forceinline__ T step(T x, T s, const Coef<T>& cf) {
  using R = Rn<T>;
  const T xv = R::abs(x);
  const T up = R::add(R::mul(cf.c_rise, s), R::mul(R::mul(cf.r_rise, xv), T(1)));
  const T down = R::add(R::mul(cf.c_fall, s), R::mul(R::mul(cf.r_fall, xv), T(0)));
  return xv >= s ? up : down;
}

struct Layout {
  long long T;
  int L;
  int vec_x, vec_out;  // 16-byte row copies of x, of out
};

__host__ __device__ __forceinline__ long long tiles_of(long long T) { return (T + TS - 1) / TS; }

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
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

// a whole tile: its steps in place on the ring, x read a group ahead into registers, no per-step check
template <typename T>
__device__ __forceinline__ T whole_tile(T* __restrict__ v, T s, const Coef<T>& cf) {
  T a[GROUP], b[GROUP];
#pragma unroll
  for (int u = 0; u < GROUP; ++u) a[u] = v[u * LANES];
#pragma unroll 1
  for (int k = 0; k < TS; k += 2 * GROUP) {
#pragma unroll
    for (int u = 0; u < GROUP; ++u) b[u] = v[(k + GROUP + u) * LANES];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      s = step(a[u], s, cf);
      v[(k + u) * LANES] = s;
    }
    if (k + 2 * GROUP < TS) {
#pragma unroll
      for (int u = 0; u < GROUP; ++u) a[u] = v[(k + 2 * GROUP + u) * LANES];
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      s = step(b[u], s, cf);
      v[(k + GROUP + u) * LANES] = s;
    }
  }
  return s;
}

// warp 0: the lanes' recurrence, reading x from and writing s to the ring
template <typename T>
__device__ __forceinline__ void consume(T* ring, const T* __restrict__ s0, T* __restrict__ s_fin, const Coef<T>& cf,
                                        const Layout& lay, long long tiles) {
  const int lane = threadIdx.x;
  const int j = blockIdx.x * LANES + lane;
  const bool live = j < lay.L;  // an idle lane computes on what the ring holds and stores nothing
  T s = T(0);
  int slot = 0;
  for (long long tile = 0; tile < tiles; ++tile) {
    T* __restrict__ v = ring + slot * (TS * LANES) + lane;
    bar_sync(FULL + slot);
    const long long left = lay.T - tile * TS;
    if (tile > 0 && left >= TS) {
      s = whole_tile(v, s, cf);
    } else {
      const int n = left < TS ? (int)left : TS;
      int k = 0;
      if (tile == 0) {  // the first step is the initial state: the one given, or |x[0]|
        s = s0 ? (live ? s0[j] : T(0)) : Rn<T>::abs(v[0]);
        v[0] = s;
        k = 1;
      }
      for (; k < n; ++k) {
        s = step(v[k * LANES], s, cf);
        v[k * LANES] = s;
      }
    }
    __threadfence_block();
    bar_arrive(EMPTY + slot);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  if (live) s_fin[j] = s;
}

// warp 1: every global access of x and out, a tile at a time
template <typename T>
__device__ __forceinline__ void produce(T* ring, const T* __restrict__ x, T* __restrict__ out, const Layout& lay,
                                        long long tiles) {
  constexpr int VEC = VEC_BYTES / (int)sizeof(T);  // items a row copy
  constexpr int COPIES_A_ROW = LANES / VEC;
  constexpr int ROWS_A_COPY = LANES / COPIES_A_ROW;  // rows of a tile one row-copy instruction covers
  const int p = threadIdx.x - LANES;
  const int lane0 = blockIdx.x * LANES;
  const long long L = lay.L;
  // an item a lane: thread p carries lane lane0 + p
  const bool live = lane0 + p < lay.L;
  // row copies: thread p moves copy p % COPIES_A_ROW of rows p / COPIES_A_ROW, + ROWS_A_COPY, ...
  const int vcol = (p % COPIES_A_ROW) * VEC, vrow = p / COPIES_A_ROW;
  const bool vlive = lane0 + vcol < lay.L;  // L is a multiple of VEC there: a copy is whole or absent

  auto rows = [&](long long tile) { return (int)min((long long)TS, lay.T - tile * TS); };
  auto issue = [&](long long tile) {
    if (tile < tiles) {
      T* dst = ring + (int)(tile % STAGES) * (TS * LANES);
      const int n = rows(tile);
      const long long t0 = tile * TS;
      if (lay.vec_x) {
        if (vlive) {
          const T* src = x + (t0 + vrow) * L + lane0 + vcol;
#pragma unroll 8
          for (int k = vrow; k < n; k += ROWS_A_COPY, src += ROWS_A_COPY * L)
            cp_async(dst + k * LANES + vcol, src, VEC_BYTES);
        }
      } else if (live) {
        const T* src = x + t0 * L + lane0 + p;
#pragma unroll 16
        for (int k = 0; k < n; ++k, src += L) cp_async(dst + k * LANES + p, src, (int)sizeof(T));
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups in flight fixed
  };
  auto drain = [&](long long tile) {
    const T* src = ring + (int)(tile % STAGES) * (TS * LANES);
    const int n = rows(tile);
    const long long t0 = tile * TS;
    if (lay.vec_out) {
      if (vlive) {
        T* dst = out + (t0 + vrow) * L + lane0 + vcol;
#pragma unroll 8
        for (int k = vrow; k < n; k += ROWS_A_COPY, dst += ROWS_A_COPY * L)
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src + k * LANES + vcol);
      }
    } else if (live) {
      T* dst = out + t0 * L + lane0 + p;
#pragma unroll 16
      for (int k = 0; k < n; ++k, dst += L) *dst = src[k * LANES + p];
    }
  };

#pragma unroll
  for (int k = 0; k < STAGES; ++k) issue(k);
  cp_async_wait<STAGES - 1>();  // tile 0 has landed
  __threadfence_block();
  __syncwarp();
  bar_arrive(FULL);
  for (long long tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {  // publish the next tile before waiting on this one
      cp_async_wait<STAGES - 2>();
      __threadfence_block();
      __syncwarp();
      bar_arrive(FULL + (int)((tile + 1) % STAGES));
    }
    bar_sync(EMPTY + (int)(tile % STAGES));  // the consumer has written this tile's states
    drain(tile);
    __syncwarp();  // every thread's reads of the slot come before any copy into it
    issue(tile + STAGES);
  }
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    envelope_kernel(const T* __restrict__ x, const T* __restrict__ s0, T* __restrict__ out, T* __restrict__ s_fin,
                    double win_fall, double win_rise, const Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const long long tiles = tiles_of(lay.T);
  if (threadIdx.x < LANES)
    consume<T>(ring, s0, s_fin, Coef<T>(win_fall, win_rise), lay, tiles);
  else
    produce<T>(ring, x, out, lay, tiles);
}

// the chain's latency on the card (hm_envelope_chain): one warp, each lane s = step(x_u, s) over n steps (n a
// multiple of CHAIN_X) with its CHAIN_X samples in registers, between two clock64 reads
constexpr int CHAIN_X = 8;

template <typename T>
__global__ void envelope_chain_kernel(const T* __restrict__ xs, double win_fall, double win_rise, int n,
                                      T* __restrict__ out, long long* __restrict__ cycles) {
  const Coef<T> cf(win_fall, win_rise);
  T x[CHAIN_X];
#pragma unroll
  for (int u = 0; u < CHAIN_X; ++u) x[u] = xs[u * LANES + threadIdx.x];
  T s = Rn<T>::abs(x[0]);
  const long long t0 = clock64();
  for (int i = 0; i < n; i += CHAIN_X) {
#pragma unroll
    for (int u = 0; u < CHAIN_X; ++u) s = step(x[u], s, cf);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// 16-byte row copies: L items make whole 16-byte vectors and the base is 16-byte aligned
int vector_rows(const void* p, int L, int itemsize) {
  return (L * (long long)itemsize) % VEC_BYTES == 0 && (size_t)p % VEC_BYTES == 0;
}

// the cut of a (T, L) call on x and out that launch makes and hm_envelope_plan reports: blocks_of(L) blocks of
// LANES lanes, tiles_of(T) tiles of TS steps, and the copy widths
int blocks_of(int L) { return (L + LANES - 1) / LANES; }

Layout layout(const void* x, const void* out, long long T, int L, int itemsize) {
  return Layout{T, L, vector_rows(x, L, itemsize), vector_rows(out, L, itemsize)};
}

template <typename T>
int launch(const void* x, const void* s0, void* out, void* s_fin, double wf, double wr, long long T_, int L,
           cudaStream_t st) {
  constexpr int smem = STAGES * TS * LANES * (int)sizeof(T);  // 64 KB in float32, 128 KB in float64
  const cudaError_t set = cudaFuncSetAttribute(envelope_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  const Layout lay = layout(x, out, T_, L, (int)sizeof(T));
  envelope_kernel<T><<<blocks_of(L), THREADS, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(s0),
                                                          static_cast<T*>(out), static_cast<T*>(s_fin), wf, wr, lay);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the constants ops/cuda/envelope_kernel.py mirrors: LANES, TS, STAGES, VEC_BYTES, CHAIN_X
void hm_envelope_constants(int* out) {
  out[0] = LANES;
  out[1] = TS;
  out[2] = STAGES;
  out[3] = VEC_BYTES;
  out[4] = CHAIN_X;
}

// xs (CHAIN_X, LANES) the samples, out (LANES,) each lane's last state, cycles (1,) the chain's clock64 cycles;
// n > 0 a multiple of CHAIN_X, dtype_code as hm_envelope's
int hm_envelope_chain(const void* xs, double win_fall, double win_rise, int n, int dtype_code, void* out,
                      long long* cycles, void* stream) {
  if (n <= 0 || n % CHAIN_X || (dtype_code != 0 && dtype_code != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype_code == 0)
    envelope_chain_kernel<float><<<1, LANES, 0, st>>>(static_cast<const float*>(xs), win_fall, win_rise, n,
                                                      static_cast<float*>(out), cycles);
  else
    envelope_chain_kernel<double><<<1, LANES, 0, st>>>(static_cast<const double*>(xs), win_fall, win_rise, n,
                                                       static_cast<double*>(out), cycles);
  return (int)cudaGetLastError();
}

// the cut hm_envelope makes of a (T, L) call on x and out (the function its launch calls), into plan: blocks,
// tiles, the last tile's steps, 16-byte row copies of x (1) or an item a lane (0), the same of out
int hm_envelope_plan(long long T, int L, int dtype_code, const void* x, const void* out, long long* plan) {
  if (T < 1 || L < 1 || (dtype_code != 0 && dtype_code != 1)) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(x, out, T, L, dtype_code == 0 ? (int)sizeof(float) : (int)sizeof(double));
  plan[0] = blocks_of(L);
  plan[1] = tiles_of(T);
  plan[2] = T - (tiles_of(T) - 1) * TS;
  plan[3] = lay.vec_x;
  plan[4] = lay.vec_out;
  return 0;
}

// x (T, L) the signal, contiguous, float32 (dtype_code 0) or float64 (1);
// s0 (L,) the state before sample 1 in the same dtype, or null: |x[0]|;
// out (T, L) and s_fin (L,).  win_fall, win_rise: the windows in samples
// (Envelope.win_lens), rounded to the dtype here.  T >= 1, L >= 1.  x and
// out each move by 16-byte row copies where L times the item size is a
// multiple of 16 and the base 16-byte aligned, else an item a lane a step;
// hm_envelope_plan reports the cut (ops/cuda/envelope_kernel.plan mirrors
// it for the CPU's model of the kernel).
int hm_envelope(const void* x, const void* s0, void* out, void* s_fin, double win_fall, double win_rise,
                long long T, int L, int dtype_code, void* stream) {
  if (T < 1 || L < 1 || (dtype_code != 0 && dtype_code != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype_code == 0) return launch<float>(x, s0, out, s_fin, win_fall, win_rise, T, L, st);
  return launch<double>(x, s0, out, s_fin, win_fall, win_rise, T, L, st);
}

}  // extern "C"
