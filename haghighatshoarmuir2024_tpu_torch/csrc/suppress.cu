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
// TB-sample time tile, staged with an M-sample halo on both sides (rounded
// up on the right to whole 32-sample words).  M is the correctness bound of
// the TPU kernel (_margin, :96-102): each pass reaches w samples and the
// extrema W + 1, so everything past M cannot change the tile's own outputs.
// Out-of-range positions (< 0, >= T) are masked by global index.
//
// Design: every flag is a bit, 32 consecutive samples of one row to a 32-bit
// word, and a thread owns one (row, word) at a time.  Candidates are sparse
// (at the flagship one sample in 27 of a polarity), so all neighbour logic is
// arithmetic on these words and heights are read only at set bits:
//   - K1 builds the rise and fall words of its 32 samples from the same
//     registers that stage cs (17 loads in flight, then their 16
//     differences, twice).  Two boundaries side by side give an extremum by a
//     shift and an and; a boundary followed by a flat sample looks for the
//     next boundary with a find-first-set over at most 2W - 1 bits and sets
//     the midpoint's bit.  Both polarities come out of that one pass.
//   - where the window is at most a word (1 <= w <= 32) a word and its
//     neighbour make one 64-bit string, and "another candidate within w", "a
//     window-max to the right within w" and "a winner within w" are smears
//     of it: log2(w) shift-or steps.  Wider windows (and w = 0) test the
//     ranges of the words per set bit.
//   - pass 1 walks the set bits of a candidate word; a candidate with no
//     other in its window (the common case) needs its own height alone, the
//     others compare with the set bits inside [t-w, t+w].
//   - both polarities share every sweep and its barriers.
// Dense candidates stay exact; they cost O(w) compares per candidate.
//
// What bounds it on the card: the bytes, and after them the operations a
// sample costs.  Device memory is touched once per input and output byte;
// where R is a multiple of 4 and the masks are 4-byte aligned, four rows'
// mask bytes move as one 32-bit word (four rows by four samples of bits
// become bytes by one multiply each and transpose by byte permutes).
// Shared memory per block is words * RB * (32 * 4 + 6 * 4) bytes,
// words = ceil((TB + 2M) / 32): the staged floats and six bit planes, 4.75
// bytes a sample.  The kernels are held to the registers that let two blocks
// share an SM: one block a time leaves the memory idle while it computes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RB = 32;      // rows per block: threadIdx.x
// Most warps per block, strided over words: threadIdx.y.  K1's flagship tile
// is 21 words, and two blocks of 21 warps fit an SM's registers
// (__launch_bounds__ holds the kernels to that).
constexpr int MAX_TY = 21;
constexpr int NPLANES = 6;

// bit planes of a tile; K1's rise and fall words are dead once the extrema
// are known, and the round's window-maxima take their place
constexpr int P_RISE = 0, P_FALL = 1;
constexpr int P_TOP = 0;  // + polarity
constexpr int P_ACT = 2;  // + polarity
constexpr int P_WIN = 4;  // + polarity

struct Tile {
  float* h;     // (NW * 32, RB) heights
  uint32_t* p;  // (NPLANES, NW, RB) bit planes: bit i of word k is sample 32 k + i
  int NW;       // words per row
  int TBe;      // NW * 32 samples
  __device__ uint32_t* plane(int k) const { return p + k * NW * RB; }
};

__device__ Tile carve(unsigned char* smem, int NW) {
  Tile s;
  s.NW = NW;
  s.TBe = NW * 32;
  s.h = reinterpret_cast<float*>(smem);
  s.p = reinterpret_cast<uint32_t*>(smem + sizeof(float) * s.TBe * RB);
  return s;
}

__host__ __device__ inline int tile_words(int TB, int M) { return (TB + 2 * M + 31) / 32; }

// Bits of word wj that lie in the sample range [lo, hi].
__device__ __forceinline__ uint32_t range_mask(int wj, int lo, int hi) {
  uint32_t m = 0xffffffffu;
  if (wj == (lo >> 5)) m &= 0xffffffffu << (lo & 31);
  if (wj == (hi >> 5)) m &= 0xffffffffu >> (31 - (hi & 31));
  return m;
}

// Whether this row's plane has a set bit in [lo, hi] (clipped to the tile).
__device__ __forceinline__ bool any_in(const uint32_t* pl, int TBe, int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, TBe - 1);
  if (lo > hi) return false;
  for (int wj = lo >> 5; wj <= (hi >> 5); ++wj)
    if (pl[wj * RB + threadIdx.x] & range_mask(wj, lo, hi)) return true;
  return false;
}

// x with every set bit smeared over the n places above it (toward later
// samples) or below it: log2(n) shift-or steps.
__device__ __forceinline__ uint64_t smear_up(uint64_t x, int n) {
  for (int reach = 0; reach < n;) {
    const int step = min(reach + 1, n - reach);
    x |= x << step;
    reach += step;
  }
  return x;
}

__device__ __forceinline__ uint64_t smear_down(uint64_t x, int n) {
  for (int reach = 0; reach < n;) {
    const int step = min(reach + 1, n - reach);
    x |= x >> step;
    reach += step;
  }
  return x;
}

// Whether a window of w samples either side is done by smears.
__device__ __forceinline__ bool narrow(int w) { return w >= 1 && w <= 32; }

// A plane's words around wi for a window of at most one word (w <= 32):
// below = (wi - 1, wi), above = (wi, wi + 1) as 64-bit strings, bit 32 of
// below and bit 0 of above being sample 32 wi.  Words off the tile are 0.
struct Around {
  uint64_t below, above;
};

__device__ __forceinline__ Around around(const uint32_t* pl, int NW, int wi) {
  const int tx = threadIdx.x;
  const uint32_t mid = pl[wi * RB + tx];
  const uint32_t lo = wi > 0 ? pl[(wi - 1) * RB + tx] : 0u;
  const uint32_t hi = wi + 1 < NW ? pl[(wi + 1) * RB + tx] : 0u;
  return {((uint64_t)mid << 32) | lo, ((uint64_t)hi << 32) | mid};
}

// Word wi of "a set bit within [t - w, t + w] other than t itself" (w <= 32).
__device__ __forceinline__ uint32_t others_within(const Around& a, int w) {
  return (uint32_t)(smear_up(a.below << 1, w - 1) >> 32) | (uint32_t)smear_down(a.above >> 1, w - 1);
}

// Pass 1 for one word of one polarity: the candidates that no other
// candidate within w exceeds.  Only the candidates in `crowded` have another
// candidate in their window; the others need their own height alone.
__device__ __forceinline__ uint32_t window_maxima(const Tile& s, const uint32_t* act, int wi, int w,
                                                  float sign, uint32_t crowded) {
  const int tx = threadIdx.x;
  uint32_t top = 0;
  for (uint32_t rem = act[wi * RB + tx]; rem; rem &= rem - 1) {
    const int i = __ffs(rem) - 1, t = wi * 32 + i;
    const float h = sign * s.h[t * RB + tx];
    bool is_top = isfinite(h);
    if ((crowded >> i) & 1u) {
      const int lo = max(t - w, 0), hi = min(t + w, s.TBe - 1);
      for (int wj = lo >> 5; is_top && wj <= (hi >> 5); ++wj) {
        uint32_t m = act[wj * RB + tx] & range_mask(wj, lo, hi);
        if (wj == wi) m &= ~(1u << i);
        for (; m; m &= m - 1)
          if (sign * s.h[(wj * 32 + __ffs(m) - 1) * RB + tx] > h) {
            is_top = false;
            break;
          }
      }
    }
    if (is_top) top |= 1u << i;
  }
  return top;
}

// Pass 2: the window-maxima with no window-max strictly to the right within w.
__device__ __forceinline__ uint32_t winners(const Tile& s, const uint32_t* top, int wi, int w) {
  if (narrow(w)) {
    const Around a = around(top, s.NW, wi);
    return (uint32_t)a.above & ~(uint32_t)smear_down(a.above >> 1, w - 1);
  }
  uint32_t win = 0;
  for (uint32_t rem = top[wi * RB + threadIdx.x]; rem; rem &= rem - 1) {
    const int i = __ffs(rem) - 1, t = wi * 32 + i;
    if (!any_in(top, s.TBe, t + 1, t + w)) win |= 1u << i;
  }
  return win;
}

// Pass 3: the candidates with no winner within w (a winner clears itself).
__device__ __forceinline__ uint32_t survivors(const Tile& s, const uint32_t* act, const uint32_t* win,
                                              int wi, int w) {
  const uint32_t a = act[wi * RB + threadIdx.x];
  if (narrow(w)) {
    const Around n = around(win, s.NW, wi);
    return a & ~((uint32_t)(smear_up(n.below, w) >> 32) | (uint32_t)smear_down(n.above, w));
  }
  uint32_t keep = 0;
  for (uint32_t rem = a; rem; rem &= rem - 1) {
    const int i = __ffs(rem) - 1, t = wi * 32 + i;
    if (!any_in(win, s.TBe, t - w, t + w)) keep |= 1u << i;
  }
  return keep;
}

// One suppression round of one or both polarities on the tile's candidate
// planes: leaves the survivors in P_ACT and the winners in P_WIN; ends
// synchronised.  Windows of at most a word (w <= 32) do the neighbour logic
// by smears of a word and its neighbour; wider ones (and w = 0) by range
// tests per set bit.
template <bool BIPOLAR>
__device__ void suppression_round(const Tile& s, int w) {
  constexpr int NPOL = BIPOLAR ? 2 : 1;
  const int tx = threadIdx.x;
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y)
    for (int pol = 0; pol < NPOL; ++pol) {
      const uint32_t* act = s.plane(P_ACT + pol);
      const uint32_t crowded = narrow(w) ? others_within(around(act, s.NW, wi), w) : 0xffffffffu;
      s.plane(P_TOP + pol)[wi * RB + tx] = window_maxima(s, act, wi, w, pol ? -1.0f : 1.0f, crowded);
    }
  __syncthreads();
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y)
    for (int pol = 0; pol < NPOL; ++pol)
      s.plane(P_WIN + pol)[wi * RB + tx] = winners(s, s.plane(P_TOP + pol), wi, w);
  __syncthreads();
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y)
    for (int pol = 0; pol < NPOL; ++pol)
      s.plane(P_ACT + pol)[wi * RB + tx] =
          survivors(s, s.plane(P_ACT + pol), s.plane(P_WIN + pol), wi, w);
  __syncthreads();
}

// Bits sh..sh+3 of a word as four bytes of 0 or 1 (the copies of the nibble
// at 0, 7, 14 and 21 do not overlap, so the product carries nothing).
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t word, int sh) {
  return (((word >> sh) & 0xfu) * 0x00204081u) & 0x01010101u;
}

// The tile's centre [M, M + TB) of N planes as (T, R) byte masks.  vec: R is
// a multiple of 4 and every out is 4-byte aligned, so four rows move as one
// word (M is a multiple of 8 and TB of 4: four samples never leave a word).
template <int N>
__device__ void store_planes(const Tile& s, const int (&planes)[N], uint8_t* const (&outs)[N], int T,
                             int R, int M, int TB, bool vec) {
  const long long g0 = (long long)blockIdx.y * TB;  // global time of local M
  if (vec) {
    const int nthreads = RB * blockDim.y;
    for (int item = threadIdx.y * RB + threadIdx.x; item < (TB / 4) * 8; item += nthreads) {
      const int q = item & 7, c = (item >> 3) * 4;  // rows 4q..4q+3, centre samples c..c+3
      const int r0 = blockIdx.x * RB + 4 * q, t = M + c;
      if (r0 >= R) continue;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const uint4 v = *reinterpret_cast<const uint4*>(s.plane(planes[n]) + (t >> 5) * RB + 4 * q);
        // four rows by four samples of bytes, transposed to four samples by four rows
        const uint32_t e0 = nibble_bytes(v.x, t & 31), e1 = nibble_bytes(v.y, t & 31);
        const uint32_t e2 = nibble_bytes(v.z, t & 31), e3 = nibble_bytes(v.w, t & 31);
        const uint32_t lo01 = __byte_perm(e0, e1, 0x5140), hi01 = __byte_perm(e0, e1, 0x7362);
        const uint32_t lo23 = __byte_perm(e2, e3, 0x5140), hi23 = __byte_perm(e2, e3, 0x7362);
        const uint32_t bytes[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                   __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
        uint8_t* out = outs[n] + (g0 + c) * R + r0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (g0 + c + k < T) *reinterpret_cast<uint32_t*>(out + (long long)k * R) = bytes[k];
      }
    }
  } else {
    const int r = blockIdx.x * RB + threadIdx.x;
    if (r >= R) return;
    for (int c = threadIdx.y; c < TB && g0 + c < T; c += blockDim.y) {
      const int t = M + c;
#pragma unroll
      for (int n = 0; n < N; ++n)
        outs[n][(g0 + c) * R + r] = (s.plane(planes[n])[(t >> 5) * RB + threadIdx.x] >> (t & 31)) & 1u;
    }
  }
}

// The tile of a (T, R) byte mask (nonzero = set) as this row's bit plane;
// returns whether this thread saw a set byte.  The plane must be zero and
// the block synchronised before (vec sets bits with atomics), and the block
// synchronises before it reads the plane.
__device__ uint32_t load_plane(const Tile& s, uint32_t* pl, const uint8_t* __restrict__ in, int T,
                               int R, long long base, bool vec) {
  uint32_t any = 0;
  if (vec) {
    // U loads in flight per thread before any is used
    constexpr int U = 8;
    const int nthreads = RB * blockDim.y, total = s.TBe * 8;
    for (int first = threadIdx.y * RB + threadIdx.x; first < total; first += U * nthreads) {
      uint32_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int item = first + u * nthreads;
        const int r0 = blockIdx.x * RB + 4 * (item & 7);
        const long long g = base + (item >> 3);
        v[u] = (item < total && r0 < R && g >= 0 && g < T)
                   ? *reinterpret_cast<const uint32_t*>(in + g * R + r0)
                   : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!v[u]) continue;
        any = 1;
        const int item = first + u * nthreads;
        const int q = item & 7, t = item >> 3;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if ((v[u] >> (8 * k)) & 0xffu) atomicOr(pl + (t >> 5) * RB + 4 * q + k, 1u << (t & 31));
      }
    }
  } else {
    const int r = blockIdx.x * RB + threadIdx.x;
    for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long g = base + wi * 32 + i;
        if (r < R && g >= 0 && g < T && in[g * R + r]) word |= 1u << i;
      }
      pl[wi * RB + threadIdx.x] = word;
      any |= word;
    }
  }
  return any;
}

__global__ void __launch_bounds__(RB * MAX_TY, 2)
    rzcc_k1_kernel(const float* __restrict__ cs, uint8_t* __restrict__ act_p,
                   uint8_t* __restrict__ act_n, uint8_t* __restrict__ kept_p,
                   uint8_t* __restrict__ kept_n, int T, int R, int w, int W, int M, int TB, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile s = carve(smem, tile_words(TB, M));
  const int tx = threadIdx.x;
  const int r = blockIdx.x * RB + tx;
  const long long base = (long long)blockIdx.y * TB - M;  // global time of local 0

  // stage cs and take the sign of each next difference on the way: a rise or
  // a fall bit where both samples are valid and inside the tile
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y) {
    const int t0 = wi * 32;
    const long long gw = base + t0;  // global time of the word's first sample
    // every sample of the word and the one after it in range: no test per sample
    const bool inside = gw >= 0 && gw + 32 < T && r < R;
    uint32_t rise = 0, fall = 0;
#pragma unroll 1
    for (int half = 0; half < 32; half += 16) {  // 17 loads in flight, then their 16 differences
      float x[17];
      if (inside) {
        const float* p = cs + (gw + half) * R + r;
#pragma unroll
        for (int i = 0; i < 17; ++i) x[i] = p[(long long)i * R];
      } else {
#pragma unroll
        for (int i = 0; i < 17; ++i) {
          const long long g = gw + half + i;
          x[i] = (g >= 0 && g < T && r < R) ? cs[g * R + r] : 0.0f;
        }
      }
      uint32_t up = 0, down = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s.h[(t0 + half + i) * RB + tx] = x[i];
        const float d = x[i + 1] - x[i];
        up |= (uint32_t)(d > 0.0f) << i;
        down |= (uint32_t)(d < 0.0f) << i;
      }
      rise |= up << half;
      fall |= down << half;
    }
    // a difference counts where both samples are valid and inside the tile
    uint32_t valid = wi + 1 < s.NW ? 0xffffffffu : 0x7fffffffu;
    if (!inside) {
      const long long lo = max(-gw, 0LL), hi = min((long long)T - 2 - gw, 31LL);  // valid bits [lo, hi]
      valid &= (lo <= hi && r < R) ? range_mask(0, (int)lo, (int)hi) : 0u;
    }
    rise &= valid;
    fall &= valid;
    s.plane(P_RISE)[wi * RB + tx] = rise;
    s.plane(P_FALL)[wi * RB + tx] = fall;
    s.plane(P_ACT)[wi * RB + tx] = 0;
    s.plane(P_ACT + 1)[wi * RB + tx] = 0;
  }
  __syncthreads();

  // bounded-plateau extrema.  Consecutive boundaries j < k enclose the run
  // [j + 1, k]; its midpoint m = (j + 1 + k) >> 1 has j within W before it
  // and k within W - 1 after it exactly when k - j <= 2W - 1, and is a
  // maximum for rise then fall, a minimum for fall then rise.
  const uint32_t* rise_pl = s.plane(P_RISE);
  const uint32_t* fall_pl = s.plane(P_FALL);
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y) {
    const uint32_t rise = rise_pl[wi * RB + tx], fall = fall_pl[wi * RB + tx];
    const uint32_t bnd = rise | fall;
    const uint32_t prev_rise = wi > 0 ? rise_pl[(wi - 1) * RB + tx] >> 31 : 0u;
    const uint32_t prev_fall = wi > 0 ? fall_pl[(wi - 1) * RB + tx] >> 31 : 0u;
    const uint32_t next_bnd =
        wi + 1 < s.NW ? (rise_pl[(wi + 1) * RB + tx] | fall_pl[(wi + 1) * RB + tx]) & 1u : 0u;
    // k = j + 1: the extremum is k itself
    const uint32_t maxima = ((rise << 1) | prev_rise) & fall;
    const uint32_t minima = ((fall << 1) | prev_fall) & rise;
    if (maxima) atomicOr(s.plane(P_ACT) + wi * RB + tx, maxima);
    if (minima) atomicOr(s.plane(P_ACT + 1) + wi * RB + tx, minima);
    // a boundary followed by a flat sample: find the plateau's other end
    for (uint32_t rem = bnd & ~((bnd >> 1) | (next_bnd << 31)); rem; rem &= rem - 1) {
      const int i = __ffs(rem) - 1, j = wi * 32 + i;
      const int lo = j + 1, hi = min(j + 2 * W - 1, s.TBe - 1);
      int k = -1;
      for (int wj = lo >> 5; lo <= hi && k < 0 && wj <= (hi >> 5); ++wj) {
        const uint32_t m = (rise_pl[wj * RB + tx] | fall_pl[wj * RB + tx]) & range_mask(wj, lo, hi);
        if (m) k = wj * 32 + __ffs(m) - 1;
      }
      if (k < 0) continue;
      const bool j_rises = (rise >> i) & 1u;
      const bool k_rises = (rise_pl[(k >> 5) * RB + tx] >> (k & 31)) & 1u;
      if (j_rises == k_rises) continue;
      const int m = (j + 1 + k) >> 1;
      atomicOr(s.plane(P_ACT + (j_rises ? 0 : 1)) + (m >> 5) * RB + tx, 1u << (m & 31));
    }
  }
  __syncthreads();

  suppression_round<true>(s, w);

  const int planes[4] = {P_ACT, P_ACT + 1, P_WIN, P_WIN + 1};
  uint8_t* const outs[4] = {act_p, act_n, kept_p, kept_n};
  store_planes(s, planes, outs, T, R, M, TB, vec);
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
                                           int T, int R, int w, int M, int TB, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NPOL = BIPOLAR ? 2 : 1;
  const Tile s = carve(smem, tile_words(TB, M));
  const int tx = threadIdx.x;
  const int r = blockIdx.x * RB + tx;
  const long long base = (long long)blockIdx.y * TB - M;
  const int flag_idx = blockIdx.y * gridDim.x + blockIdx.x;
  int act_planes[NPOL];
  uint8_t* act_outs[NPOL];
  for (int pol = 0; pol < NPOL; ++pol) {
    act_planes[pol] = P_ACT + pol;
    act_outs[pol] = pol ? act_n_out : act_p_out;
  }

  if (vec) {
    for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y)
      for (int pol = 0; pol < NPOL; ++pol) s.plane(P_ACT + pol)[wi * RB + tx] = 0;
    __syncthreads();
  }
  uint32_t any = load_plane(s, s.plane(P_ACT), act_p_in, T, R, base, vec);
  if (BIPOLAR) any |= load_plane(s, s.plane(P_ACT + 1), act_n_in, T, R, base, vec);
  if (!__syncthreads_or(any)) {
    // no candidate can reach this tile: the round changes nothing here (the
    // planes are all zero)
    store_planes(s, act_planes, act_outs, T, R, M, TB, vec);
    if (tx == 0 && threadIdx.y == 0) flags[flag_idx] = 0;
    return;
  }
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y) {
    float x[32];  // a word's samples in flight together
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long g = base + wi * 32 + i;
      x[i] = (g >= 0 && g < T && r < R) ? h[g * R + r] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s.h[(wi * 32 + i) * RB + tx] = x[i];
  }
  __syncthreads();

  suppression_round<BIPOLAR>(s, w);

  store_planes(s, act_planes, act_outs, T, R, M, TB, vec);
  // the new winners of the centre join kept; candidates left there raise the flag
  int remaining = 0;
  const long long g0 = (long long)blockIdx.y * TB;
  for (int wi = threadIdx.y; wi < s.NW; wi += blockDim.y) {
    const int lo = max(M, wi * 32), hi = min(M + TB - 1, wi * 32 + 31);
    if (lo > hi) continue;
    const uint32_t centre = range_mask(wi, lo, hi);
    for (int pol = 0; pol < NPOL; ++pol) {
      uint8_t* kept = pol ? kept_n : kept_p;
      for (uint32_t rem = s.plane(P_WIN + pol)[wi * RB + tx] & centre; rem; rem &= rem - 1) {
        const long long g = g0 + (wi * 32 + __ffs(rem) - 1 - M);
        if (g < T && r < R) kept[g * R + r] = 1;
      }
      remaining |= (s.plane(P_ACT + pol)[wi * RB + tx] & centre) != 0;
    }
  }
  remaining = __syncthreads_or(remaining);
  if (tx == 0 && threadIdx.y == 0) flags[flag_idx] = remaining != 0;
}

__global__ void __launch_bounds__(RB * MAX_TY, 2)
    rzcc_k2_kernel(const float* __restrict__ cs, const uint8_t* __restrict__ act_p_in,
                   const uint8_t* __restrict__ act_n_in, uint8_t* __restrict__ act_p_out,
                   uint8_t* __restrict__ act_n_out, uint8_t* __restrict__ kept_p,
                   uint8_t* __restrict__ kept_n, int* __restrict__ flags, int T, int R, int w, int M,
                   int TB, int vec) {
  round_body<true>(cs, act_p_in, act_n_in, act_p_out, act_n_out, kept_p, kept_n, flags, T, R, w, M,
                   TB, vec);
}

__global__ void __launch_bounds__(RB * MAX_TY, 2)
    suppress_k7_kernel(const float* __restrict__ height, const uint8_t* __restrict__ act_in,
                       uint8_t* __restrict__ act_out, uint8_t* __restrict__ kept,
                       int* __restrict__ flags, int T, int R, int w, int M, int TB, int vec) {
  round_body<false>(height, act_in, nullptr, act_out, nullptr, kept, nullptr, flags, T, R, w, M, TB,
                    vec);
}

size_t smem_bytes(int TB, int M) {
  return (size_t)tile_words(TB, M) * RB * (32 * sizeof(float) + NPLANES * sizeof(uint32_t));
}

dim3 block_dim(int TB, int M) { return dim3(RB, min(tile_words(TB, M), MAX_TY)); }

// Whether four rows' mask bytes can move as one 32-bit word.
template <typename... Ptr>
int vectorisable(int R, Ptr... masks) {
  return R % 4 == 0 && ((reinterpret_cast<uintptr_t>(masks) % 4 == 0) && ...);
}

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
  rzcc_k1_kernel<<<grid, block_dim(TB, M), smem, (cudaStream_t)stream>>>(
      cs, act_p, act_n, kept_p, kept_n, T, R, w, W, M, TB,
      vectorisable(R, act_p, act_n, kept_p, kept_n));
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
  rzcc_k2_kernel<<<grid, block_dim(TB, M), smem, (cudaStream_t)stream>>>(
      cs, act_p_in, act_n_in, act_p_out, act_n_out, kept_p, kept_n, flags, T, R, w, M, TB,
      vectorisable(R, act_p_in, act_n_in, act_p_out, act_n_out));
  return (int)cudaGetLastError();
}

int hm_suppress_k7(const float* height, const uint8_t* act_in, uint8_t* act_out, uint8_t* kept,
                   int* flags, int T, int R, int w, int M, int TB, void* stream) {
  const size_t smem = smem_bytes(TB, M);
  cudaError_t err = cudaFuncSetAttribute(suppress_k7_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + RB - 1) / RB, (T + TB - 1) / TB);
  suppress_k7_kernel<<<grid, block_dim(TB, M), smem, (cudaStream_t)stream>>>(
      height, act_in, act_out, kept, flags, T, R, w, M, TB, vectorisable(R, act_in, act_out));
  return (int)cudaGetLastError();
}

const char* hm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
