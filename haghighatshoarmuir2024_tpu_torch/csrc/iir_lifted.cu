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
// start, one FMA a term), and every thread works on one column: a column's
// result is a function of that column alone, the same at 14 columns as at
// 1344.
//
// Per column (x: SB-sample blocks b, N-dimensional state, Q blocks a
// super-block at level 2; the matrices are the plain version's, float32):
//   1. increments  sp[b] = proj[SB..SB+N] . x_blk   (the block's sum of y and
//                  its state increment: N + 1 rows of the projection);
//   2. level 2     UV[i] = WsBm2 . sP[super-block i] (skipping each row
//                  tile's trailing zero columns, which the block-triangular
//                  Ws has);
//   3. recurrence  one thread a column, sequential: e = cP + h1m.U, its
//                  exclusive prefix over the super-block (a running sum,
//                  q ascending: the LTexSum product), the carried state
//                  s_prev = U + Ps.s and c_prev = (c + cumE) + Hc.s of every
//                  block, then s = ASBQ.s + V, c = (c + sumE) + sum_h.s; at
//                  level 1 (Q <= 2, or no modal basis) the block recurrence
//                  s = ASB.s + sP, c = (c + cP) + h1.s itself;
//   4. assembly    z = (G2 . x_blk + Hout . s_prev) + c_prev, one thread a
//                  (block, column).
// Four launches at level 2, three at level 1, in place of the plain
// version's einsums, nb2 x 4 small matmuls, stacks and assembly passes.
//
// What bounds it on the card: the bytes (x read twice, z written once) and
// the float32 FFMA work of 1, 2 and 4, about 1.6 GFLOP at the flagship
// (L = 1344, T = 12 000); TF32 and the tensor cores are not involved.  Each
// (block, column) thread keeps its block of x in registers, and the
// matrices it applies are broadcast from shared memory; warps run along
// the columns, so every access to x, z and the scratch is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LT = 128;    // columns a block of threads (threadIdx.x)
constexpr int RT = 16;     // rows of WsBm2 a level-2 thread accumulates
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

// 1. The block's sum of y and its state increment: rows SB..SB+N of proj.
// sp: (nb, N+1, L), entries 0..N-1 the increment, N the sum.
template <int SBM>
__global__ void __launch_bounds__(LT) increments_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ proj,
                                                        float* __restrict__ sp, int T, int L, int SB, int N) {
  __shared__ float rows[(N_MAX + 1) * SB_MAX];
  const int b = blockIdx.x, l = blockIdx.y * LT + threadIdx.x;
  for (int k = threadIdx.x; k < (N + 1) * SB; k += LT) rows[k] = proj[SB * SB + k];
  __syncthreads();
  if (l >= L) return;
  float xr[SBM];
  load_block<SBM>(x, T, L, SB, b, l, xr);
  for (int k = 0; k <= N; ++k) {
    const float* r = rows + k * SB;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < SBM; ++i)
      if (i < SB) acc = fmaf(r[i], xr[i], acc);
    // proj's row SB is the sum, rows SB+1.. the increment
    sp[((long long)b * (N + 1) + (k == 0 ? N : k - 1)) * L + l] = acc;
  }
}

// 2. UV[i, r] = sum_k WsBm2[r, k] sP[i*Q + k/N, k%N] for the RT rows of a tile,
// k ascending up to the tile's last nonzero column.
__global__ void __launch_bounds__(LT) level2_kernel(const float* __restrict__ sp,
                                                    const float* __restrict__ w2,
                                                    const int* __restrict__ kend, float* __restrict__ uv,
                                                    int L, int N, int Q, int tiles) {
  __shared__ __align__(16) float w[K2_MAX * RT];  // [k][r]
  const int i = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int l = blockIdx.y * LT + threadIdx.x;
  const int K2 = Q * N, R2 = (Q + 1) * N, r0 = tile * RT;
  const int ke = kend[tile];
  for (int e = threadIdx.x; e < ke * RT; e += LT) {
    const int k = e / RT, r = e % RT;
    w[e] = r0 + r < R2 ? w2[(long long)(r0 + r) * K2 + k] : 0.f;
  }
  __syncthreads();
  if (l >= L) return;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  const float* col = sp + (long long)i * Q * (N + 1) * L + l;
  int k = 0;
  for (int q = 0; k < ke; ++q) {
    for (int n = 0; n < N && k < ke; ++n, ++k) {
      const float v = __ldg(col + ((long long)q * (N + 1) + n) * L);
      const float4* wk = reinterpret_cast<const float4*>(w + k * RT);
#pragma unroll
      for (int r4 = 0; r4 < RT / 4; ++r4) {
        const float4 c = wk[r4];
        acc[4 * r4 + 0] = fmaf(c.x, v, acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(c.y, v, acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(c.z, v, acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(c.w, v, acc[4 * r4 + 3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r0 + r < R2) uv[((long long)i * R2 + r0 + r) * L + l] = acc[r];
}

struct Recurrence {
  const float* sp;   // (nb, N+1, L) increments and sums
  const float* uv;   // (nb2, (Q+1)N, L) level 2's U and V
  const float* zi;   // (L, N+1) or null
  const float* ablk; // ASBQ (level 2) or ASB
  const float* hblk; // sum_h or h1
  const float* tinv; const float* tm; const float* h1m; const float* ps; const float* hc;
  float* spv;        // (nb, N+1, L) out: s_prev, c_prev of every block
  float* state;      // (L, N+1) out
  int L, N, Q, nb, level2;
};

// 3. One thread a column: the recurrence over the super-blocks (level 2) or
// the blocks (level 1), writing every block's incoming state.
template <int NM>
__global__ void __launch_bounds__(64) recurrence_kernel(const Recurrence a) {
  const int l = blockIdx.x * 64 + threadIdx.x;
  if (l >= a.L) return;
  const int N = a.N, L = a.L;
  const long long row = (long long)(N + 1) * L;
  float s[NM], c = 0.f;
#pragma unroll
  for (int n = 0; n < NM; ++n) s[n] = (a.zi != nullptr && n < N) ? a.zi[(long long)l * (N + 1) + n] : 0.f;
  if (a.zi != nullptr) c = a.zi[(long long)l * (N + 1) + N];
  if (a.level2) {
    float t[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) t[n] = n < N ? dot<NM>(a.tinv + n * N, s, N) : 0.f;  // into the modal basis
#pragma unroll
    for (int n = 0; n < NM; ++n) s[n] = t[n];
    const int Q = a.Q, nb2 = a.nb / Q, R2 = (Q + 1) * N;
    for (int i = 0; i < nb2; ++i) {
      const float* U = a.uv + (long long)i * R2 * L + l;
      float run = 0.f;  // the exclusive prefix of e over the super-block
#pragma unroll 4
      for (int q = 0; q < Q; ++q) {
        const long long b = (long long)i * Q + q;
        float u[NM];
#pragma unroll
        for (int n = 0; n < NM; ++n) u[n] = n < N ? __ldg(U + (long long)(q * N + n) * L) : 0.f;
        const float e = __ldg(a.sp + b * row + (long long)N * L + l) + dot<NM>(a.h1m, u, N);
        float* out = a.spv + b * row + l;
#pragma unroll
        for (int n = 0; n < NM; ++n)
          if (n < N) out[(long long)n * L] = u[n] + dot<NM>(a.ps + (q * N + n) * N, s, N);
        out[(long long)N * L] = (c + run) + dot<NM>(a.hc + q * N, s, N);
        run += e;
      }
      float sn[NM];
#pragma unroll
      for (int n = 0; n < NM; ++n) sn[n] = n < N ? dot<NM>(a.ablk + n * N, s, N) + __ldg(U + (long long)(Q * N + n) * L) : 0.f;
      c = (c + run) + dot<NM>(a.hblk, s, N);
#pragma unroll
      for (int n = 0; n < NM; ++n) s[n] = sn[n];
    }
    float t2[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) t2[n] = n < N ? dot<NM>(a.tm + n * N, s, N) : 0.f;  // back to the TDF2 basis
#pragma unroll
    for (int n = 0; n < NM; ++n) s[n] = t2[n];
  } else {
#pragma unroll 4
    for (int b = 0; b < a.nb; ++b) {
      const float* in = a.sp + (long long)b * row + l;
      float* out = a.spv + (long long)b * row + l;
      float sn[NM];
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        if (n < N) out[(long long)n * L] = s[n];
        sn[n] = n < N ? dot<NM>(a.ablk + n * N, s, N) + __ldg(in + (long long)n * L) : 0.f;
      }
      out[(long long)N * L] = c;
      c = (c + __ldg(in + (long long)N * L)) + dot<NM>(a.hblk, s, N);
#pragma unroll
      for (int n = 0; n < NM; ++n) s[n] = sn[n];
    }
  }
  if (a.state != nullptr) {
#pragma unroll
    for (int n = 0; n < NM; ++n)
      if (n < N) a.state[(long long)l * (N + 1) + n] = s[n];
    a.state[(long long)l * (N + 1) + N] = c;
  }
}

// 4. z = (G2 . x_blk + Hout . s_prev) + c_prev for the SB samples of block b.
template <int SBM, int NM>
__global__ void __launch_bounds__(LT) assemble_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                                                      const float* __restrict__ hout,
                                                      const float* __restrict__ spv, float* __restrict__ z,
                                                      int T, int L, int SB, int N) {
  __shared__ __align__(16) float g2[SB_MAX * SB_MAX];
  __shared__ float h[SB_MAX * N_MAX];
  const int b = blockIdx.x, l = blockIdx.y * LT + threadIdx.x;
  for (int k = threadIdx.x; k < SB * SB; k += LT) g2[k] = proj[k];
  for (int k = threadIdx.x; k < SB * N; k += LT) h[k] = hout[k];
  __syncthreads();
  if (l >= L) return;
  float xr[SBM], sv[NM];
  load_block<SBM>(x, T, L, SB, b, l, xr);
  const float* in = spv + (long long)b * (N + 1) * L + l;
#pragma unroll
  for (int n = 0; n < NM; ++n) sv[n] = n < N ? __ldg(in + (long long)n * L) : 0.f;
  const float cp = __ldg(in + (long long)N * L);
  const long long t0 = (long long)b * SB;
  for (int j = 0; j < SB && t0 + j < T; ++j) {
    const float* g = g2 + j * SB;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < SBM; ++i)
      if (i < SB) acc = fmaf(g[i], xr[i], acc);
    float hs = 0.f;
#pragma unroll
    for (int n = 0; n < NM; ++n)
      if (n < N) hs = fmaf(h[j * N + n], sv[n], hs);
    z[(t0 + j) * L + l] = (acc + hs) + cp;
  }
}

template <int SBM, int NM>
int launch(const float* x, const float* zi, float* z, float* state, float* sp, float* spv, float* uv,
           const float* proj, const float* hout, const float* ablk, const float* hblk, const float* tinv,
           const float* tm, const float* h1m, const float* ps, const float* hc, const float* w2, const int* kend,
           int T, int L, int SB, int N, int Q, int nb, int level2, cudaStream_t st) {
  const dim3 grid(nb, (L + LT - 1) / LT);
  increments_kernel<SBM><<<grid, LT, 0, st>>>(x, proj, sp, T, L, SB, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (level2) {
    const int tiles = ((Q + 1) * N + RT - 1) / RT;
    level2_kernel<<<dim3((nb / Q) * tiles, (L + LT - 1) / LT), LT, 0, st>>>(sp, w2, kend, uv, L, N, Q, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const Recurrence r{sp, uv, zi, ablk, hblk, tinv, tm, h1m, ps, hc, spv, state, L, N, Q, nb, level2};
  recurrence_kernel<NM><<<(L + 63) / 64, 64, 0, st>>>(r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assemble_kernel<SBM, NM><<<grid, LT, 0, st>>>(x, proj, hout, spv, z, T, L, SB, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (T, L), zi (L, N+1) or null, z (T, L), state (L, N+1) or null; sp, spv
// (nb, N+1, L) and uv (nb/Q, (Q+1)N, L) scratch; the matrices as
// ops/cuda/iir_kernel.kernel_matrices lays them out (SB_MAX, N_MAX, K2_MAX and
// RT are its constants too).
int hm_iir_lifted(const float* x, const float* zi, float* z, float* state, float* sp, float* spv, float* uv,
                  const float* proj, const float* hout, const float* ablk, const float* hblk, const float* tinv,
                  const float* tm, const float* h1m, const float* ps, const float* hc, const float* w2,
                  const int* kend, int T, int L, int SB, int N, int Q, int nb, int level2, void* stream) {
  if (SB < 1 || SB > SB_MAX || N < 1 || N > N_MAX || (level2 && Q * N > K2_MAX) || T < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define HM_IIR_ARGS x, zi, z, state, sp, spv, uv, proj, hout, ablk, hblk, tinv, tm, h1m, ps, hc, w2, kend, \
                    T, L, SB, N, Q, nb, level2, st
  if (SB <= 32) return N <= 4 ? launch<32, 4>(HM_IIR_ARGS) : launch<32, 8>(HM_IIR_ARGS);
  return N <= 4 ? launch<64, 4>(HM_IIR_ARGS) : launch<64, 8>(HM_IIR_ARGS);
#undef HM_IIR_ARGS
}

}  // extern "C"
