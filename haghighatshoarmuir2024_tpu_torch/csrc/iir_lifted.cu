// The lifted blocked IIR cumsum for Hopper (sm_90a): cumsum(lfilter(b, a, x))
// along time, column by column, with the carried TDF2 state and integrator
// total (ops/iir.iir_cumsum_blocked; JAX iir_filter(method="blocked_cumsum"),
// haghighatshoarmuir2024_tpu/ops/iir.py:375-517).
//
// Replaces no TPU kernel: the JAX package computes this through XLA, and the
// port's plain version (ops/iir.iir_cumsum_blocked_plain) through about 25
// tensor ops whose GEMMs go to cuBLAS.  On the card cuBLAS picks its GEMM
// kernel, and so the order in which a dot product's terms are added, by the
// shape of the whole call, so a stream's result depended on how many other
// streams shared its call (below 336 columns the level-2 products change
// kernel).  Here every output element is a sum whose terms are added in one
// fixed order that the column count does not change (k ascending from a zero
// start, one FMA a term), and every thread works on its own column: a
// column's result is a function of that column alone, the same at 14
// columns as at 1344.
//
// Per column (x: SB-sample blocks b, N-dimensional state, Q blocks a
// super-block at level 2; the matrices are the plain version's, float32):
//   increments  the block's sum of y, cP[b] = proj[SB] . x_blk, and its state
//               increment sP[b] = proj[SB+1..SB+N] . x_blk;
//   level 2     U and V = WsBm2 . sP[super-block] (skipping each row tile's
//               trailing zero columns, which the block-triangular Ws has),
//               e = cP + h1m . U a block and run, e's exclusive running sum
//               over the super-block (q ascending);
//   outer       s = ASBQ . s + V, c = (c + sum e) + sum_h . s a super-block,
//               from the carried state (through Tinv; out through Tm);
//   entry       s_prev = U + Ps . s and c_prev = (c + run) + Hc . s of a block;
//   assembly    z = (G2 . x_blk + Hout . s_prev) + c_prev.
// At level 1 (Q <= 2, or no modal basis) the block recurrence s = ASB . s +
// sP, c = (c + cP) + h1 . s itself gives every block's entry state.
//
// Level 2 runs in two launches.  (a) superblock_kernel, a block of threads a
// (super-block, tile of 32 columns): its 16 warps stream the super-block's x
// once (two blocks of x in flight a warp), keep the increments in shared
// memory, apply the level-2 rows (a warp a tile of 8 rows, the tiles dealt in
// a snake so the triangle's short and long tiles pair up, the tile's
// coefficients staged in shared memory 64 columns at a time and read as
// float4 broadcasts, one increment load feeding 8 FMAs), and write only U, V,
// run and e's total.
// (b) assemble_kernel, a thread a (block, column): with its column of the
// block in flight to shared memory (cp.async), it first runs its column's
// outer recurrence up to its super-block (at most nb/Q steps of N x N, the
// same steps in the same order in every block, so it needs no launch of its
// own), forms s_prev and c_prev in registers and writes z, reading G2 as
// float4 broadcasts from shared memory and only its lower triangle (the
// upper one is zero: each skipped term would add an exact zero).  Level 1
// keeps three launches: the increments, one thread a column's block
// recurrence, the same assembly.  How the work is split over launches and
// blocks changes no sum: each output's terms and their order are fixed by
// the column alone (k ascending in every product, run q ascending, (c + run)
// + Hc . s, (G2 . x + Hout . s_prev) + c_prev).
//
// What bounds it on the card: the bytes, x read twice and z written once
// (3 x 64.5 MB at the flagship, L = 1344, T = 12 000: 0.058 ms at 3.35 TB/s;
// the function's own least bytes, x in and z out, 0.0385 ms), and float32
// FFMA work of about 0.7 GFLOP there (the assembly's triangle most of it);
// TF32 and the tensor cores are not involved.  Warps run along the columns,
// so every access to x, z and the scratch is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LT = 128;    // columns a block of the assembly and the level-1 kernels (threadIdx.x)
constexpr int LA = 32;     // columns a super-block pass block
constexpr int WA = 16;     // warps a super-block pass block
constexpr int RT = 8;      // rows of WsBm2 a level-2 warp accumulates
constexpr int KC = 64;     // columns of a level-2 tile a warp stages at a time (two a lane)
constexpr int SB_MAX = 64;
constexpr int N_MAX = 8;
constexpr int K2_MAX = 512;  // Q * N (iir.lifted_plan's bound)

// The dot product sum_k a[k] * v[k] over k < n, ascending from a zero start.
template <int NM>
__device__ __forceinline__ float dot(const float* __restrict__ a, const float (&v)[NM], int n) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NM; ++k)
    if (k < n) acc = fmaf(__ldg(a + k), v[k], acc);
  return acc;
}

// x's SB samples of block b, column l (zero past T).
template <int SBM>
__device__ __forceinline__ void load_block(const float* __restrict__ x, int T, int L, int SB, int b, int l,
                                           float (&xr)[SBM]) {
  const long long t0 = (long long)b * SB;
#pragma unroll
  for (int i = 0; i < SBM; ++i)
    xr[i] = (i < SB && t0 + i < T) ? __ldg(x + (t0 + i) * L + l) : 0.f;
}

// One float of x into shared memory by cp.async, zero where the sample or
// column lies outside x (the source is then not read); the copy bypasses the
// registers, so it stays in flight while the thread works on other things.
__device__ __forceinline__ void cp_async_float(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
#else
  *dst = valid ? *src : 0.f;
#endif
}

// Wait for this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// proj's increment rows SB..SB+N into shared memory, each padded with zeros
// to a whole number of float4s (sbp floats).
__device__ __forceinline__ void load_rows(const float* __restrict__ proj, float* rows, int SB, int N, int sbp) {
  for (int k = threadIdx.x; k < (N + 1) * sbp; k += blockDim.x) {
    const int r = k / sbp, i = k % sbp;
    rows[k] = i < SB ? proj[(SB + r) * SB + i] : 0.f;
  }
}

// Row k of the increments (k = 0 the block sum, k = 1.. the state
// increment): sum_i rows[k][i] x[i], i ascending, the row read as float4s.
template <int SBM>
__device__ __forceinline__ float increment(const float* rows, const float (&xr)[SBM], int SB, int sbp, int k) {
  const float4* r = reinterpret_cast<const float4*>(rows + k * sbp);
  float acc = 0.f;
#pragma unroll
  for (int i4 = 0; i4 < SBM / 4; ++i4) {
    if (4 * i4 < SB) {
      const float4 w = r[i4];
      acc = fmaf(w.x, xr[4 * i4 + 0], acc);
      if (4 * i4 + 1 < SB) acc = fmaf(w.y, xr[4 * i4 + 1], acc);
      if (4 * i4 + 2 < SB) acc = fmaf(w.z, xr[4 * i4 + 2], acc);
      if (4 * i4 + 3 < SB) acc = fmaf(w.w, xr[4 * i4 + 3], acc);
    }
  }
  return acc;
}

// ---------------------------------------------------------------- level 2, (a)
struct SuperBlock {
  const float* x;
  const float* proj;  // (SB+1+N, SB)
  const float* w2t;   // (Q N, tiles RT): WsBm2 transposed, rows padded with zeros
  const int* kend;    // (tiles,): a tile's columns up to its last nonzero one
  const float* h1m;   // (N,)
  float* u;           // (nb, N, L)
  float* v;           // (nb/Q, N, L)
  float* run;         // (nb, L): e's exclusive running sum within the super-block
  float* total;       // (nb/Q, L): e's sum over the super-block
  int T, L, SB, N, Q, tiles;
};

__host__ __device__ constexpr size_t superblock_smem(int SBP, int N, int Q) {
  // the increments sP [Q N][LA], U [Q N][LA], cP then e [Q][LA], proj's increment rows [N+1][SBP],
  // each warp's staged coefficients [KC][RT]
  return sizeof(float) * ((size_t)2 * Q * N * LA + (size_t)Q * LA + (size_t)(N + 1) * SBP + (size_t)WA * KC * RT);
}
// the most any call asks for (Q N <= K2_MAX, Q <= K2_MAX, N <= N_MAX): 231 680 bytes of the 232 448
constexpr size_t SUPERBLOCK_SMEM_MAX =
    sizeof(float) * ((size_t)3 * K2_MAX * LA + (size_t)(N_MAX + 1) * SB_MAX + (size_t)WA * KC * RT);
static_assert(SUPERBLOCK_SMEM_MAX <= 232448, "the super-block pass's shared memory");

template <int SBM, int NM>
__global__ void __launch_bounds__(WA * 32) superblock_kernel(const SuperBlock a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, Q = a.Q, SB = a.SB, L = a.L, K2 = Q * N, sbp = (SB + 3) / 4 * 4;
  float* sp = smem;                 // [k][col]
  float* us = sp + K2 * LA;         // [k][col]
  float* ce = us + K2 * LA;         // [q][col]: cP, then e
  float* rows = ce + Q * LA;        // [N+1][sbp]
  const int i = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = blockIdx.y * LA + lane;
  const bool live = l < L;
  load_rows(a.proj, rows, SB, N, sbp);
  __syncthreads();

  // the increments of the super-block's Q blocks, a warp QP blocks at a time (their loads all in flight)
  constexpr int QP = SBM <= 32 ? 2 : 1;
  for (int q0 = warp; q0 < Q; q0 += QP * WA) {
    float xr[QP][SBM];
#pragma unroll
    for (int p = 0; p < QP; ++p)
      if (q0 + p * WA < Q) load_block<SBM>(a.x, a.T, L, SB, i * Q + q0 + p * WA, live ? l : 0, xr[p]);
#pragma unroll
    for (int p = 0; p < QP; ++p) {
      const int q = q0 + p * WA;
      if (q < Q) {
        ce[q * LA + lane] = increment<SBM>(rows, xr[p], SB, sbp, 0);
        for (int n = 0; n < N; ++n) sp[(q * N + n) * LA + lane] = increment<SBM>(rows, xr[p], SB, sbp, n + 1);
      }
    }
  }
  __syncthreads();

  // level 2: tile t's rows r0..r0+RT, k ascending up to the tile's kend; the
  // warps take the tiles in a snake, so the short and long tiles of the
  // triangle pair up.  A warp stages its tile's coefficients KC columns at a
  // time in its own piece of shared memory (lane j copies columns k0 + j and
  // k0 + 32 + j), the next chunk's loads in flight while it works through the
  // current one.
  constexpr int R4 = RT / 4, KL = KC / 32;
  float4* wbuf = reinterpret_cast<float4*>(rows + (N + 1) * sbp) + warp * KC * R4;
  for (int j = 0;; ++j) {
    const int t = (j & 1) ? (j + 1) * WA - 1 - warp : j * WA + warp;
    if (t >= a.tiles) break;
    const int r0 = t * RT, ke = __ldg(a.kend + t), W4 = a.tiles * R4;
    const float4* w = reinterpret_cast<const float4*>(a.w2t) + r0 / 4;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    float4 next[KL][R4];
#pragma unroll
    for (int c = 0; c < KL; ++c)
#pragma unroll
      for (int r4 = 0; r4 < R4; ++r4) {
        const int k = c * 32 + lane;
        next[c][r4] = k < ke ? __ldg(w + (long long)k * W4 + r4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    for (int k0 = 0; k0 < ke; k0 += KC) {
      __syncwarp();
#pragma unroll
      for (int c = 0; c < KL; ++c)
#pragma unroll
        for (int r4 = 0; r4 < R4; ++r4) wbuf[(c * 32 + lane) * R4 + r4] = next[c][r4];
      __syncwarp();
#pragma unroll
      for (int c = 0; c < KL; ++c)
#pragma unroll
        for (int r4 = 0; r4 < R4; ++r4) {
          const int k = k0 + KC + c * 32 + lane;
          if (k < ke) next[c][r4] = __ldg(w + (long long)k * W4 + r4);
        }
      const int kc = min(KC, ke - k0);
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float v = sp[(k0 + kk) * LA + lane];
#pragma unroll
        for (int r4 = 0; r4 < R4; ++r4) {
          const float4 c = wbuf[kk * R4 + r4];
          acc[4 * r4 + 0] = fmaf(c.x, v, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(c.y, v, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(c.z, v, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(c.w, v, acc[4 * r4 + 3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = r0 + r;
      if (row < K2) {
        us[row * LA + lane] = acc[r];
        if (live) a.u[((long long)i * K2 + row) * L + l] = acc[r];
      } else if (row < K2 + N && live) {
        a.v[((long long)i * N + row - K2) * L + l] = acc[r];
      }
    }
  }
  __syncthreads();

  // e = cP + h1m . U of every block
  for (int q = warp; q < Q; q += WA) {
    float u[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) u[n] = n < N ? us[(q * N + n) * LA + lane] : 0.f;
    ce[q * LA + lane] = ce[q * LA + lane] + dot<NM>(a.h1m, u, N);
  }
  __syncthreads();

  // run: e's exclusive running sum, q ascending, one thread a column
  if (warp == 0 && live) {
    float run = 0.f;
    float* out = a.run + (long long)i * Q * L + l;
#pragma unroll 4
    for (int q = 0; q < Q; ++q) {
      out[(long long)q * L] = run;
      run += ce[q * LA + lane];
    }
    a.total[(long long)i * L + l] = run;
  }
}

// ---------------------------------------------------------------- level 1
// The increments: sp (nb, N+1, L), entries 0..N-1 the increment, N the sum.
template <int SBM>
__global__ void __launch_bounds__(LT) increments_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ proj,
                                                        float* __restrict__ sp, int T, int L, int SB, int N) {
  __shared__ __align__(16) float rows[(N_MAX + 1) * SB_MAX];
  const int b = blockIdx.x, l = blockIdx.y * LT + threadIdx.x, sbp = (SB + 3) / 4 * 4;
  load_rows(proj, rows, SB, N, sbp);
  __syncthreads();
  if (l >= L) return;
  float xr[SBM];
  load_block<SBM>(x, T, L, SB, b, l, xr);
  for (int k = 0; k <= N; ++k)
    sp[((long long)b * (N + 1) + (k == 0 ? N : k - 1)) * L + l] = increment<SBM>(rows, xr, SB, sbp, k);
}

// One thread a column: the block recurrence, writing every block's incoming
// state into spv (nb, N+1, L) and the final one into state.
template <int NM>
__global__ void __launch_bounds__(64) recurrence_kernel(const float* __restrict__ sp, const float* __restrict__ zi,
                                                        const float* __restrict__ ablk,
                                                        const float* __restrict__ hblk, float* __restrict__ spv,
                                                        float* __restrict__ state, int L, int N, int nb) {
  const int l = blockIdx.x * 64 + threadIdx.x;
  if (l >= L) return;
  const long long row = (long long)(N + 1) * L;
  float s[NM], c = 0.f;
#pragma unroll
  for (int n = 0; n < NM; ++n) s[n] = (zi != nullptr && n < N) ? zi[(long long)l * (N + 1) + n] : 0.f;
  if (zi != nullptr) c = zi[(long long)l * (N + 1) + N];
#pragma unroll 4
  for (int b = 0; b < nb; ++b) {
    const float* in = sp + (long long)b * row + l;
    float* out = spv + (long long)b * row + l;
    float sn[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      if (n < N) out[(long long)n * L] = s[n];
      sn[n] = n < N ? dot<NM>(ablk + n * N, s, N) + __ldg(in + (long long)n * L) : 0.f;
    }
    out[(long long)N * L] = c;
    c = (c + __ldg(in + (long long)N * L)) + dot<NM>(hblk, s, N);
#pragma unroll
    for (int n = 0; n < NM; ++n) s[n] = sn[n];
  }
#pragma unroll
  for (int n = 0; n < NM; ++n)
    if (n < N) state[(long long)l * (N + 1) + n] = s[n];
  state[(long long)l * (N + 1) + N] = c;
}

// ---------------------------------------------------------------- the assembly
struct Assembly {
  const float* x;
  const float* proj;  // G2 in its first SB rows
  const float* hout;  // (SB, N)
  const float* zi;    // (L, N+1) or null
  // level 2: the outer recurrence's and the entry's matrices, and pass (a)'s outputs
  const float* ablk; const float* hblk; const float* tinv; const float* tm; const float* ps; const float* hc;
  const float* u; const float* v; const float* run; const float* total;
  const float* spv;   // level 1: (nb, N+1, L) the entry states
  float* z;
  float* state;       // level 2: (L, N+1), written by the last block
  int T, L, SB, N, Q, nb, level2;
};

template <int SBM, int NM>
__global__ void __launch_bounds__(LT) assemble_kernel(const Assembly a) {
  constexpr int SBP = (SBM + 3) / 4 * 4;
  __shared__ __align__(16) float g2[SBM * SBP];  // G2 [j][i], rows padded to whole float4s
  __shared__ float h[SB_MAX * N_MAX];
  extern __shared__ float xs[];                   // [i][thread]: the block of x, by cp.async
  const int b = blockIdx.x, l = blockIdx.y * LT + threadIdx.x;
  const int SB = a.SB, N = a.N, L = a.L;
  const int sbp = (SB + 3) / 4 * 4;
  const long long t0 = (long long)b * SB;
  // this thread's column of the block, in flight through the outer recurrence below
  for (int i = 0; i < SB; ++i)
    cp_async_float(xs + i * LT + threadIdx.x, a.x + (t0 + i < a.T ? t0 + i : 0) * L + (l < L ? l : 0),
                   t0 + i < a.T && l < L);
  for (int k = threadIdx.x; k < SB * sbp; k += LT) {
    const int j = k / sbp, i = k % sbp;
    g2[j * SBP + i] = i < SB ? a.proj[j * SB + i] : 0.f;
  }
  for (int k = threadIdx.x; k < SB * N; k += LT) h[k] = a.hout[k];
  __syncthreads();
  if (l >= L) return;

  float sv[NM], cp;
  if (a.level2) {
    const int Q = a.Q, i = b / Q, q = b % Q;
    float u[NM];  // loaded with x, ahead of the outer recurrence
#pragma unroll
    for (int n = 0; n < NM; ++n) u[n] = n < N ? __ldg(a.u + ((long long)b * N + n) * L + l) : 0.f;
    const float run = __ldg(a.run + (long long)b * L + l);
    float s[NM], c = 0.f;
#pragma unroll
    for (int n = 0; n < NM; ++n) s[n] = (a.zi != nullptr && n < N) ? a.zi[(long long)l * (N + 1) + n] : 0.f;
    if (a.zi != nullptr) c = a.zi[(long long)l * (N + 1) + N];
    float t[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) t[n] = n < N ? dot<NM>(a.tinv + n * N, s, N) : 0.f;  // into the modal basis
#pragma unroll
    for (int n = 0; n < NM; ++n) s[n] = t[n];
    const bool last = b == a.nb - 1;
    for (int k = 0; k < i + (last ? 1 : 0); ++k) {  // the outer recurrence up to super-block i (the last: past it)
      if (k == i) {  // the last block: the entry state of its super-block before the final step
#pragma unroll
        for (int n = 0; n < NM; ++n) sv[n] = n < N ? u[n] + dot<NM>(a.ps + (q * N + n) * N, s, N) : 0.f;
        cp = (c + run) + dot<NM>(a.hc + q * N, s, N);
      }
      float sn[NM];
#pragma unroll
      for (int n = 0; n < NM; ++n)
        sn[n] = n < N ? dot<NM>(a.ablk + n * N, s, N) + __ldg(a.v + ((long long)k * N + n) * L + l) : 0.f;
      c = (c + __ldg(a.total + (long long)k * L + l)) + dot<NM>(a.hblk, s, N);
#pragma unroll
      for (int n = 0; n < NM; ++n) s[n] = sn[n];
    }
    if (last) {
#pragma unroll
      for (int n = 0; n < NM; ++n) t[n] = n < N ? dot<NM>(a.tm + n * N, s, N) : 0.f;  // back to the TDF2 basis
#pragma unroll
      for (int n = 0; n < NM; ++n)
        if (n < N) a.state[(long long)l * (N + 1) + n] = t[n];
      a.state[(long long)l * (N + 1) + N] = c;
    } else {
#pragma unroll
      for (int n = 0; n < NM; ++n) sv[n] = n < N ? u[n] + dot<NM>(a.ps + (q * N + n) * N, s, N) : 0.f;
      cp = (c + run) + dot<NM>(a.hc + q * N, s, N);
    }
  } else {
    const float* in = a.spv + (long long)b * (N + 1) * L + l;
#pragma unroll
    for (int n = 0; n < NM; ++n) sv[n] = n < N ? __ldg(in + (long long)n * L) : 0.f;
    cp = __ldg(in + (long long)N * L);
  }

  cp_async_wait_all();
  float xr[SBM];
#pragma unroll
  for (int i = 0; i < SBM; ++i) xr[i] = i < SB ? xs[i * LT + threadIdx.x] : 0.f;
#pragma unroll
  for (int j = 0; j < SBM; ++j) {
    if (j < SB && t0 + j < a.T) {
      const float4* g = reinterpret_cast<const float4*>(g2 + j * SBP);
      float acc = 0.f;
#pragma unroll
      for (int i4 = 0; i4 <= j / 4; ++i4) {  // G2's row j up to its diagonal
        const float4 w = g[i4];
        acc = fmaf(w.x, xr[4 * i4 + 0], acc);
        if (4 * i4 + 1 <= j) acc = fmaf(w.y, xr[4 * i4 + 1], acc);
        if (4 * i4 + 2 <= j) acc = fmaf(w.z, xr[4 * i4 + 2], acc);
        if (4 * i4 + 3 <= j) acc = fmaf(w.w, xr[4 * i4 + 3], acc);
      }
      float hs = 0.f;
#pragma unroll
      for (int n = 0; n < NM; ++n)
        if (n < N) hs = fmaf(h[j * N + n], sv[n], hs);
      a.z[(t0 + j) * L + l] = (acc + hs) + cp;
    }
  }
}

// The opt-in to more than 48 KB of shared memory, once a kernel and device.
template <class K>
cudaError_t opt_in(K kernel, size_t bytes, unsigned long long& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (opted >> dev & 1))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) opted |= 1ULL << dev;
  return err;
}

template <int SBM, int NM>
int launch(const float* x, const float* zi, float* z, float* state, float* scratch, const float* proj,
           const float* hout, const float* ablk, const float* hblk, const float* tinv, const float* tm,
           const float* h1m, const float* ps, const float* hc, const float* w2t, const int* kend, int T, int L,
           int SB, int N, int Q, int nb, int level2, cudaStream_t st) {
  const dim3 grid(nb, (L + LT - 1) / LT);
  cudaError_t err;
  Assembly as{x, proj, hout, zi, ablk, hblk, tinv, tm, ps, hc, nullptr, nullptr, nullptr, nullptr, nullptr, z, state,
              T, L, SB, N, Q, nb, level2};
  if (level2) {
    const int nb2 = nb / Q, tiles = ((Q + 1) * N + RT - 1) / RT;
    float* u = scratch;
    float* v = u + (size_t)nb * N * L;
    float* run = v + (size_t)nb2 * N * L;
    float* total = run + (size_t)nb * L;
    const SuperBlock sb{x, proj, w2t, kend, h1m, u, v, run, total, T, L, SB, N, Q, tiles};
    const size_t smem = superblock_smem((SB + 3) / 4 * 4, N, Q);
    static unsigned long long opted = 0;  // a bit a device
    err = opt_in(superblock_kernel<SBM, NM>, SUPERBLOCK_SMEM_MAX, opted);
    if (err != cudaSuccess) return (int)err;
    superblock_kernel<SBM, NM><<<dim3(nb2, (L + LA - 1) / LA), WA * 32, smem, st>>>(sb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    as.u = u; as.v = v; as.run = run; as.total = total;
  } else {
    float* sp = scratch;
    float* spv = sp + (size_t)nb * (N + 1) * L;
    increments_kernel<SBM><<<grid, LT, 0, st>>>(x, proj, sp, T, L, SB, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    recurrence_kernel<NM><<<(L + 63) / 64, 64, 0, st>>>(sp, zi, ablk, hblk, spv, state, L, N, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    as.spv = spv;
  }
  static unsigned long long opted = 0;
  err = opt_in(assemble_kernel<SBM, NM>, (size_t)SBM * LT * sizeof(float), opted);
  if (err != cudaSuccess) return (int)err;
  assemble_kernel<SBM, NM><<<grid, LT, (size_t)SB * LT * sizeof(float), st>>>(as);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch a call needs: level 2 U, V, run and total; level 1 the
// increments and the entry states.
long long hm_iir_lifted_scratch(int L, int N, int Q, int nb, int level2) {
  if (level2) return (long long)L * ((long long)nb * N + (long long)(nb / Q) * N + nb + nb / Q);
  return 2LL * nb * (N + 1) * L;
}

// x (T, L), zi (L, N+1) or null, z (T, L), state (L, N+1); scratch of
// hm_iir_lifted_scratch floats; the matrices as
// ops/cuda/iir_kernel.kernel_matrices lays them out (SB_MAX, N_MAX, K2_MAX and
// RT are its constants too).
int hm_iir_lifted(const float* x, const float* zi, float* z, float* state, float* scratch, const float* proj,
                  const float* hout, const float* ablk, const float* hblk, const float* tinv, const float* tm,
                  const float* h1m, const float* ps, const float* hc, const float* w2t, const int* kend, int T,
                  int L, int SB, int N, int Q, int nb, int level2, void* stream) {
  if (SB < 1 || SB > SB_MAX || N < 1 || N > N_MAX || (level2 && Q * N > K2_MAX) || T < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define HM_IIR_ARGS x, zi, z, state, scratch, proj, hout, ablk, hblk, tinv, tm, h1m, ps, hc, w2t, kend, \
                    T, L, SB, N, Q, nb, level2, st
  if (SB <= 32) return N <= 4 ? launch<32, 4>(HM_IIR_ARGS) : launch<32, 8>(HM_IIR_ARGS);
  return N <= 4 ? launch<64, 4>(HM_IIR_ARGS) : launch<64, 8>(HM_IIR_ARGS);
#undef HM_IIR_ARGS
}

}  // extern "C"
