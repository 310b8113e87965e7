// Integer-LIF spike counts for Hopper (sm_90a) from the two RZCC polarity
// masks: kernels K3 and K4 and their pack pass.  K5 and K6, from one int8
// spike raster, are in lif_raster.cu; the dynamics and the two launch
// layouts (rec == 0, rec != 0) that all four share are set out in
// lif_common.cuh.
//
// K3 replaces the Pallas kernel _lif_kernel_bipolar of
// haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:275 (public entry
// lif_count_rates_bipolar, :407).  K4 replaces _lif_kernel_bipolar_stateful
// (:468, public entry lif_count_stateful_bipolar, :605), the serving
// runtime's per-chunk LIF: K3 with the (B, N) isyn/vmem/spk state loaded at
// the start and stored at the end.
//
// What bounds them: operations.  At the flagship (B = 96, T = 12 000,
// C = 14, N = 449) their function needs 10 integer operations per neuron and
// step plus one add per set input bit and neuron, 5.7e9, which is 0.183 ms
// at the card's integer rate (experiments/roofline.py); its bytes, the masks
// read once, take a tenth of that.  Their first design staged each chunk of
// 1024 steps in shared memory as 64-bit mask words, every block of a row
// reading the same (T, B, C) bytes one at a time, 1344 bytes apart, behind a
// barrier; and in the step loop the chain waited on a shared load of the
// word, a bit scan and a dependent shared load of each weight.  It took
// 2.75 ms: the staging alone 1.80, the step loop alone over words staged
// once 1.79, the LIF operations alone at the same launch shape 0.25
// (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W).  So the design
// here takes the inputs off the chain:
//
//   pack   lif_pack_bipolar_kernel reads the two byte masks once, coalesced,
//          as 32-bit words, and writes row-major (B, Tp) arrays, Tp = T
//          rounded up to PACK_T: one mask word per (b, t), bit c kp & ~kn and
//          bit C + c kn (32 bits where 2C <= 32, 64 where 2C <= 64, else two
//          64-bit words, Word128: a template parameter); one 64-bit word of
//          slots per (b, t), its SLOTS lowest set bits c as bytes c + 1 (up
//          to 128: a byte); and per PACK_T steps the most set bits a step
//          has.  It is the counterpart of the Pallas kernel's mask
//          combination (lif_kernel.py:300-307); K3's and K4's times include
//          it.
//   chain  each warp copies its row's slots into shared memory STAGE steps
//          at a time, one global load's latency a chunk.  Then one unrolled
//          loop per group of U steps steps the chain and, beside each step,
//          computes the current of the same step of the next group: per slot
//          a byte permute gives the weight row's offset and one shared load
//          its weight, with no branch and nothing the chain waits on: the
//          counterpart of the Pallas kernel filling inp_ref before its step
//          loop (:300-315).  A chunk whose steps have at most four set bits
//          reads four slots a step, else six.  At the flagship no step has
//          more than six, and nine steps in ten have at most two.  A step
//          with more, as dense masks have, puts its chunk on an out-of-line
//          loop over the mask words.  The rec == 0 layout has no barrier.
//          What the loop still pays is issuing its slot and weight
//          instructions beside the chain's ten, and the weight loads through
//          shared memory (PERF.md).
//
// The three mask-word widths compile as three translation units, side by
// side: this file builds the 32-bit words and the C interface; lif_w64.cu
// and lif_w128.cu include it with HM_LIF_WORD_TU set to 64 or 128 and build
// only that width's pack and K3/K4 instantiations, which this file reaches
// through hm_lif_pack_w<bits> and hm_lif_bipolar_w<bits>.
#include <type_traits>

#include "lif_common.cuh"

namespace {

constexpr int NT = 64;             // neurons per block when rec == 0
constexpr int BIPOLAR_MAX_C = 64;  // channels per polarity: 2C bits in a Word128
constexpr int SLOTS = 6;           // set bits a step's 64-bit word of slots names

// ------------------------------------------------------------ mask words
// The mask word of 64 < 2C <= 128 bits: bit c in lo for c < 64, else bit
// c - 64 of hi.  The three word types share the operations below, so that
// the pack's slot loop and the out-of-line word loop are written once.
struct __align__(16) Word128 {
  unsigned long long lo, hi;
};

// The lowest set bit of m plus one, 0 for none.
__device__ __forceinline__ int lowest(uint32_t m) { return __ffs((int)m); }
__device__ __forceinline__ int lowest(unsigned long long m) { return __ffsll((long long)m); }
__device__ __forceinline__ int lowest(Word128 m) {
  return m.lo ? __ffsll((long long)m.lo) : m.hi ? 64 + __ffsll((long long)m.hi) : 0;
}
__device__ __forceinline__ int popcount(uint32_t m) { return __popc(m); }
__device__ __forceinline__ int popcount(unsigned long long m) { return __popcll(m); }
__device__ __forceinline__ int popcount(Word128 m) { return __popcll(m.lo) + __popcll(m.hi); }
// m without its lowest set bit
template <typename W>
__device__ __forceinline__ W clear_lowest(W m) { return m & (m - 1); }
__device__ __forceinline__ Word128 clear_lowest(Word128 m) {
  return m.lo ? Word128{m.lo & (m.lo - 1), m.hi} : Word128{0, m.hi & (m.hi - 1)};
}
template <typename W>
__device__ __forceinline__ bool any_set(W m) { return m != 0; }
__device__ __forceinline__ bool any_set(Word128 m) { return (m.lo | m.hi) != 0; }
// m |= v << s for the low four bits of v (the pack's four channels), s < 2C
template <typename W>
__device__ __forceinline__ void set_bits(W& m, uint32_t v, int s) { m |= (W)v << s; }
__device__ __forceinline__ void set_bits(Word128& m, uint32_t v, int s) {
  if (s < 64) {
    m.lo |= (unsigned long long)v << s;
    if (s > 60) m.hi |= (unsigned long long)v >> (64 - s);  // the bits past 63
  } else {
    m.hi |= (unsigned long long)v << (s - 64);
  }
}
template <typename W>
__device__ __forceinline__ W load_word(const W* p) { return __ldg(p); }
__device__ __forceinline__ Word128 load_word(const Word128* p) {
  const ulonglong2 x = __ldg(reinterpret_cast<const ulonglong2*>(p));
  return Word128{x.x, x.y};
}

// ------------------------------------------------------------ K3/K4: pack

// One block per tile of PACK_T steps x PACK_B rows, PACK_B warps of 32
// lanes.  A step's tile row, the PACK_B rows' C bytes, is span contiguous
// bytes of the (T, B, C) masks: a warp copies it into shared memory as the
// aligned 32-bit words that cover it, every load of a thread in flight
// together (S words per step, odd, so that lanes on different steps read
// distinct banks).  Lane t of warp r then takes row r's bytes at step t out
// of the words with funnel shifts, four channels at a time, turns each
// nonzero byte into a bit and writes
//   words[b, t]  the mask word;
//   slots[b, t]  its SLOTS lowest set bits c as bytes c + 1 (0 for none);
//   most[b, t / PACK_T]  the most set bits a step of the tile has.
// Steps in [T, Tp) get zeros.  The aligned words may reach up to 3 bytes
// before and after a tile row; they lie in the same 4-byte words as bytes of
// the masks, so within their allocation.
template <typename W>
__global__ void lif_pack_bipolar_kernel(const uint8_t* __restrict__ kp,
                                        const uint8_t* __restrict__ kn, W* __restrict__ words,
                                        unsigned long long* __restrict__ slots,
                                        int* __restrict__ most, int T, int Tp, int B, int C) {
  // the channels a tile row is sized for: 64 for Word128 (33.5 KB of static
  // shared memory), 32 for the narrower words, the flagship's as before
  constexpr int TILE_C = sizeof(W) > 8 ? BIPOLAR_MAX_C : 32;
  constexpr int MAX_W = PACK_B * TILE_C / 4 + 2;  // words covering a step's tile row
  constexpr int S = MAX_W + 1;
  constexpr int STEPS = PACK_T / PACK_B;  // step rows per warp
  constexpr int PER = (MAX_W + 31) / 32;  // words per lane and step row
  __shared__ uint32_t s_p[PACK_T * S], s_n[PACK_T * S];
  const int lane = threadIdx.x, r = threadIdx.y;
  const int t0 = blockIdx.x * PACK_T, b0 = blockIdx.y * PACK_B;
  const int rows = min(PACK_B, B - b0);
  const int span = rows * C;
  // the byte address of a tile row's first byte, from the step's first row
  auto row_start = [&](const uint8_t* m, int t) {
    return reinterpret_cast<uintptr_t>(m + ((size_t)t * B + b0) * C);
  };
  uint32_t vp[STEPS][PER], vn[STEPS][PER];
#pragma unroll
  for (int ii = 0; ii < STEPS; ++ii) {
    const int t = t0 + r + ii * PACK_B;
    const uintptr_t ap = row_start(kp, t), an = row_start(kn, t);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(ap & ~(uintptr_t)3);
    const uint32_t* wn = reinterpret_cast<const uint32_t*>(an & ~(uintptr_t)3);
    const int np = (int)(((ap & 3) + span + 3) >> 2), nn = (int)(((an & 3) + span + 3) >> 2);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int w = lane + 32 * k;
      vp[ii][k] = t < T && w < np ? __ldg(wp + w) : 0;
      vn[ii][k] = t < T && w < nn ? __ldg(wn + w) : 0;
    }
  }
#pragma unroll
  for (int ii = 0; ii < STEPS; ++ii) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int w = lane + 32 * k;
      if (w < S) {
        s_p[(r + ii * PACK_B) * S + w] = vp[ii][k];
        s_n[(r + ii * PACK_B) * S + w] = vn[ii][k];
      }
    }
  }
  __syncthreads();
  if (r >= rows) return;
  const int t = t0 + lane;
  W m{};
  if (t < T) {
    const int op = (int)(row_start(kp, t) & 3) + r * C, on = (int)(row_start(kn, t) & 3) + r * C;
    const uint32_t* p = s_p + lane * S;
    const uint32_t* q = s_n + lane * S;
    for (int k = 0; 4 * k < C; ++k) {
      const int bp = op + 4 * k, bn = on + 4 * k;  // channels 4k.. of row r, as bytes from here
      const uint32_t x = __funnelshift_r(p[bp >> 2], p[(bp >> 2) + 1], 8 * (bp & 3));
      const uint32_t y = __funnelshift_r(q[bn >> 2], q[(bn >> 2) + 1], 8 * (bn & 3));
      const uint32_t keep = 0x01010101u >> (8 * max(0, 4 - (C - 4 * k)));  // channels < C
      const uint32_t neg = __vcmpne4(y, 0) & keep;
      const uint32_t pos = __vcmpne4(x, 0) & keep & ~neg;  // -1 wins on collision
      // four 0/1 bytes -> four bits: v * 0x01020408 puts byte j's bit at 24 + j
      set_bits(m, (pos * 0x01020408u) >> 24, 4 * k);
      set_bits(m, (neg * 0x01020408u) >> 24, C + 4 * k);
    }
  }
  const size_t at = (size_t)(b0 + r) * Tp + t;
  words[at] = m;
  const int bits = __reduce_max_sync(0xffffffffu, (unsigned)popcount(m));
  unsigned long long sl = 0;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k, m = clear_lowest(m)) sl |= (unsigned long long)lowest(m) << (8 * k);
  slots[at] = sl;
  if (lane == 0) most[(size_t)(b0 + r) * (Tp / PACK_T) + blockIdx.x] = bits;
}

// ----------------------------------------------------------- K3/K4: chain
// Arguments of K3 and K4, the pack's three outputs among them.  isyn0 ==
// nullptr starts from zeros; the outputs isyn_out/vmem_out/spk_out are
// written only when non-null.  spk0 holds 0/1 values, as the dynamics leave
// it.
struct BipolarArgs {
  const void* words;                // (B, Tp) of the pack's word type
  const unsigned long long* slots;  // (B, Tp)
  const int* most;                  // (B, Tp / PACK_T)
  const int* w_in;                  // (2C, N)
  const int* dash_syn;
  const int* dash_mem;
  const int* thr;
  const int* isyn0;
  const int* vmem0;
  const int* spk0;
  int* counts;
  int* isyn_out;
  int* vmem_out;
  int* spk_out;
  int T, Tp, B, C, N, rec;
};

constexpr int U = 8;         // steps per group: the chain's unrolled loop
constexpr int STAGE = 512;   // steps of slots a warp stages in shared memory at a time
constexpr int STAGE_WORDS = 2 * STAGE + STAGE / PACK_T;  // the slots, then the tiles' most
static_assert(NT * sizeof(int) == 256, "a weight row is 256 bytes: slot k's row at k << 8");

// Where a thread finds the weight of slot k (k = c + 1 of input bit c, 0 for
// none), given as the byte offset k << 8: rec == 0 its shared column, whose
// row 0 is zero and row k is w_in[k - 1]; rec != 0 the read-only cache.
template <bool REC>
struct Weights {
  const int* col;
  const int* w_in;
  int N, n;
  bool live;
  __device__ __forceinline__ int operator()(uint32_t row_bytes) const {
    if (!REC) return *reinterpret_cast<const int*>(reinterpret_cast<const char*>(col) + row_bytes);
    const int k = row_bytes >> 8;
    return (live && k > 0) ? __ldg(&w_in[(size_t)(k - 1) * N + n]) : 0;
  }
};

// Slot j of a word of four, as its weight row's byte offset: one byte
// permute puts byte j at bits 8-15.
template <int J>
__device__ __forceinline__ uint32_t slot_row(uint32_t w) {
  return __byte_perm(w, 0, 0x4404 | (J << 4));
}

// A step's current from its first K slots (K = 4 or SLOTS): no branch, K
// weight loads.
template <int K, bool REC>
__device__ __forceinline__ int slot_current(unsigned long long s, const Weights<REC>& wt) {
  static_assert((K == 4 || K == 6) && SLOTS == 6, "four slots in the low word, two in the high");
  const uint32_t lo = (uint32_t)s, hi = (uint32_t)(s >> 32);
  int cur = wt(slot_row<0>(lo)) + wt(slot_row<1>(lo)) + wt(slot_row<2>(lo)) + wt(slot_row<3>(lo));
  if (K == 6) cur += wt(slot_row<0>(hi)) + wt(slot_row<1>(hi));
  return cur;
}

// The slots of the U steps from t of a staged chunk, 16 bytes at a time
// (every lane reads the same words: broadcasts).
__device__ __forceinline__ void group_slots(unsigned long long (&q)[U], const uint32_t* stage,
                                            int t) {
#pragma unroll
  for (int v = 0; v < U / 2; ++v) {
    const uint4 x = reinterpret_cast<const uint4*>(stage + 2 * t)[v];
    q[2 * v] = ((unsigned long long)x.y << 32) | x.x;
    q[2 * v + 1] = ((unsigned long long)x.w << 32) | x.z;
  }
}

// The chain state a chunk walks.
struct ChainState {
  int isyn, vmem, spk, cnt, row_spikes;
};

// A chunk of len steps with a step of more than SLOTS set bits, step by
// step from the whole mask words.  Never at the flagship's densities (at
// most six set bits a step there), every chunk of dense masks.  Out of
// line, so that the common chunk's loop keeps its own registers and
// schedule.
template <typename W, bool CLIP, bool REC>
__device__ __noinline__ void chunk_from_words(ChainState& s, const W* __restrict__ words, int len,
                                              const Weights<REC> wt, int ds, int dm, int th,
                                              int rec) {
  for (int t = 0; t < len; ++t) {
    int cur = REC ? rec * s.row_spikes : 0;
    for (W m = load_word(&words[t]); any_set(m); m = clear_lowest(m)) cur += wt((uint32_t)lowest(m) << 8);
    const bool fired = lif_step<CLIP>(s.isyn, s.vmem, cur, ds, dm, th, wt.live);
    s.cnt += fired ? 1 : 0;
    s.spk = fired ? 1 : 0;
    if (REC) s.row_spikes = __syncthreads_count(fired);
  }
}

// The shared body of K3 and K4; W is the pack's word type.  Each warp walks
// the row in chunks of STAGE steps: it copies the chunk's slots and its
// tiles' most set bits into its own stage in shared memory, then runs the
// chain over the chunk's groups of U steps.  The loop over a group steps
// the chain and, beside each step, computes the current of the same step of
// the next group from slots already in registers, whose weight loads so fill
// the chain's latency; two groups a turn, in two sets of registers, so that
// nothing is moved.  A chunk whose steps have at most four set bits reads
// four slots a step, else six; more than six, the whole words.  The global
// loads' latency is paid once a chunk.
template <typename W, bool CLIP, bool REC>
__device__ __forceinline__ void lif_bipolar_body(const BipolarArgs& a) {
  // rec == 0: (2C + 1, NT) ints, a zero row and the weight columns; then per
  // warp STAGE_WORDS words
  extern __shared__ __align__(16) int smem_bipolar[];
  const int T = a.T, Tp = a.Tp, N = a.N;
  const int tx = threadIdx.x, lane = tx % 32;
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + tx;
  const bool live = n < N;
  const size_t at = (size_t)b * N + n;
  int* s_w = smem_bipolar;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem_bipolar + (REC ? 0 : (2 * a.C + 1) * NT)) +
                    (tx / 32) * STAGE_WORDS;
  if (!REC) {
    if (n - lane >= N) return;  // a warp with no live neuron; no barrier in this layout
    s_w[tx] = 0;
    for (int c = 0; c < 2 * a.C; ++c) s_w[(c + 1) * NT + tx] = live ? a.w_in[(size_t)c * N + n] : 0;
  }
  const Weights<REC> wt{s_w + tx, a.w_in, N, n, live};
  const int ds = live ? a.dash_syn[n] : 0;
  const int dm = live ? a.dash_mem[n] : 0;
  const int th = live ? a.thr[n] : 0;
  int isyn = 0, vmem = 0, spk = 0, cnt = 0;
  if (a.isyn0 != nullptr && live) {
    isyn = a.isyn0[at];
    vmem = a.vmem0[at];
    spk = a.spk0[at];
  }
  // the row's spike count of the previous step; every thread of the block
  // takes part in each __syncthreads_count
  int row_spikes = REC ? __syncthreads_count(spk != 0) : 0;
  auto step = [&](int cur) {
    if (REC) cur += a.rec * row_spikes;
    const bool fired = lif_step<CLIP>(isyn, vmem, cur, ds, dm, th, live);
    cnt += fired ? 1 : 0;
    spk = fired ? 1 : 0;
    if (REC) row_spikes = __syncthreads_count(fired);
  };
  auto tail = [&](const int (&cur)[U], int r) {  // the chunk's last group, up to T
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (j < r) step(cur[j]);
  };
  // the chunk of len staged steps with at most K set bits a step
  auto run = [&](auto k_slots, int len) {
    constexpr int K = decltype(k_slots)::value;
    unsigned long long qa[U], qb[U];
    int ca[U], cb[U];
    group_slots(qa, stage, 0);
#pragma unroll
    for (int j = 0; j < U; ++j) ca[j] = slot_current<K>(qa[j], wt);
    group_slots(qb, stage, U);
    for (int g = 0;; g += 2 * U) {
      if (g + U >= len) return tail(ca, len - g);
      group_slots(qa, stage, min(g + 2 * U, STAGE - U));
#pragma unroll
      for (int j = 0; j < U; ++j) {
        step(ca[j]);
        cb[j] = slot_current<K>(qb[j], wt);
      }
      if (g + 2 * U >= len) return tail(cb, len - g - U);
      group_slots(qb, stage, min(g + 3 * U, STAGE - U));
#pragma unroll
      for (int j = 0; j < U; ++j) {
        step(cb[j]);
        ca[j] = slot_current<K>(qa[j], wt);
      }
    }
  };

  const unsigned long long* slots = a.slots + (size_t)b * Tp;
  const int* most = a.most + (size_t)b * (Tp / PACK_T);
  const W* words = static_cast<const W*>(a.words) + (size_t)b * Tp;
  for (int c0 = 0; c0 < T; c0 += STAGE) {
    // the chunk's slots, 8 steps a lane, and its tiles' most set bits (Tp is
    // a multiple of PACK_T, so a lane's 8 steps are all in the row or all
    // past it)
    __syncwarp();
    for (int t = c0 + 8 * lane; t < c0 + STAGE; t += 8 * 32) {
      const uint4* src = reinterpret_cast<const uint4*>(slots + t);
      uint4* dst = reinterpret_cast<uint4*>(stage + 2 * (t - c0));
#pragma unroll
      for (int v = 0; v < 4; ++v) dst[v] = t < Tp ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
    }
    for (int k = lane; k < STAGE / PACK_T; k += 32)
      stage[2 * STAGE + k] = c0 + PACK_T * k < Tp ? __ldg(&most[c0 / PACK_T + k]) : 0;
    __syncwarp();
    const int len = min(STAGE, T - c0);
    int bits = 0;  // the same for every thread of the block
    for (int k = 0; k * PACK_T < len; ++k) bits = max(bits, (int)stage[2 * STAGE + k]);
    if (bits <= 4) {
      run(std::integral_constant<int, 4>(), len);
    } else if (bits <= SLOTS) {
      run(std::integral_constant<int, SLOTS>(), len);
    } else {
      ChainState st{isyn, vmem, spk, cnt, row_spikes};
      chunk_from_words<W, CLIP, REC>(st, words + c0, len, wt, ds, dm, th, a.rec);
      isyn = st.isyn, vmem = st.vmem, spk = st.spk, cnt = st.cnt, row_spikes = st.row_spikes;
    }
  }
  if (live) {
    a.counts[at] = cnt;
    if (a.isyn_out != nullptr) {
      a.isyn_out[at] = isyn;
      a.vmem_out[at] = vmem;
      a.spk_out[at] = spk;
    }
  }
}

// K3: counts from a zero state.  The bounds let a rec != 0 row of NT_MAX
// threads launch (at most 64 registers a thread).
template <typename W, bool CLIP, bool REC>
__global__ void __launch_bounds__(REC ? NT_MAX : NT) lif_count_bipolar_kernel(BipolarArgs a) {
  lif_bipolar_body<W, CLIP, REC>(a);
}

// K4: counts and the final state from a given state.
template <typename W, bool CLIP, bool REC>
__global__ void __launch_bounds__(REC ? NT_MAX : NT) lif_count_stateful_bipolar_kernel(BipolarArgs a) {
  lif_bipolar_body<W, CLIP, REC>(a);
}

// K3/K4's block shape in both layouts: threads per block, grid, dynamic
// shared bytes (the weight columns; the stages come on top).
struct Shape {
  dim3 grid;
  int threads;
  size_t smem;
};

Shape shape_for(int B, int C, int N, int rec) {
  if (rec != 0) return {dim3(1, B), (N + 31) / 32 * 32, 0};
  return {dim3((N + NT - 1) / NT, B), NT, (size_t)(2 * C + 1) * NT * sizeof(int)};
}

template <bool STATEFUL, typename W, bool CLIP, bool REC>
int launch_bipolar(const BipolarArgs& a, cudaStream_t st) {
  const Shape s = shape_for(a.B, a.C, a.N, a.rec);
  const size_t stages = (size_t)s.threads / 32 * STAGE_WORDS * sizeof(uint32_t);
  // each warp stages STAGE_WORDS * 4 = 4160 bytes: above 48 KB from 12 warps,
  // which only the rec != 0 layout reaches (rows of 353+ neurons)
  const size_t smem = (a.rec ? 0 : s.smem) + stages;
  auto kernel = STATEFUL ? lif_count_stateful_bipolar_kernel<W, CLIP, REC>
                         : lif_count_bipolar_kernel<W, CLIP, REC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<s.grid, s.threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool STATEFUL, typename W>
int dispatch_bipolar_w(const BipolarArgs& a, int clip, cudaStream_t st) {
  if (clip && a.rec) return launch_bipolar<STATEFUL, W, true, true>(a, st);
  if (clip) return launch_bipolar<STATEFUL, W, true, false>(a, st);
  if (a.rec) return launch_bipolar<STATEFUL, W, false, true>(a, st);
  return launch_bipolar<STATEFUL, W, false, false>(a, st);
}

template <typename W>
int launch_pack(const uint8_t* kp, const uint8_t* kn, void* words, unsigned long long* slots, int* most,
                int T, int Tp, int B, int C, cudaStream_t st) {
  const dim3 grid(Tp / PACK_T, (B + PACK_B - 1) / PACK_B), block(32, PACK_B);
  lif_pack_bipolar_kernel<W><<<grid, block, 0, st>>>(kp, kn, (W*)words, slots, most, T, Tp, B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// One width's pack pass and K3/K4 (``a`` points at a BipolarArgs, laid out
// alike in every translation unit): defined by lif_w64.cu and lif_w128.cu.
#define HM_LIF_WIDTH_API(bits)                                                                    \
  extern "C" int hm_lif_pack_w##bits(const uint8_t* kp, const uint8_t* kn, void* words,          \
                                     unsigned long long* slots, int* most, int T, int Tp, int B, \
                                     int C, void* stream);                                        \
  extern "C" int hm_lif_bipolar_w##bits(const void* a, int stateful, int clip, void* stream);
HM_LIF_WIDTH_API(64)
HM_LIF_WIDTH_API(128)

#if defined(HM_LIF_WORD_TU)
#if HM_LIF_WORD_TU == 64
using TuWord = unsigned long long;
#define HM_LIF_TU_FN(name) name##_w64
#else
using TuWord = Word128;
#define HM_LIF_TU_FN(name) name##_w128
#endif
extern "C" int HM_LIF_TU_FN(hm_lif_pack)(const uint8_t* kp, const uint8_t* kn, void* words,
                                         unsigned long long* slots, int* most, int T, int Tp, int B,
                                         int C, void* stream) {
  return launch_pack<TuWord>(kp, kn, words, slots, most, T, Tp, B, C, (cudaStream_t)stream);
}
extern "C" int HM_LIF_TU_FN(hm_lif_bipolar)(const void* a, int stateful, int clip, void* stream) {
  const BipolarArgs& args = *static_cast<const BipolarArgs*>(a);
  const cudaStream_t st = (cudaStream_t)stream;
  return stateful ? dispatch_bipolar_w<true, TuWord>(args, clip, st)
                  : dispatch_bipolar_w<false, TuWord>(args, clip, st);
}
#else
namespace {

// K3 (STATEFUL false) and K4 on words packed by lif_pack_bipolar_kernel.
template <bool STATEFUL>
int dispatch_bipolar(const BipolarArgs& a, int clip, void* stream) {
  if (a.C < 1 || a.C > BIPOLAR_MAX_C || a.Tp % PACK_T != 0 || a.Tp < a.T)
    return (int)cudaErrorInvalidValue;
  if (2 * a.C <= 32) return dispatch_bipolar_w<STATEFUL, uint32_t>(a, clip, (cudaStream_t)stream);
  if (2 * a.C <= 64) return hm_lif_bipolar_w64(&a, STATEFUL, clip, stream);
  return hm_lif_bipolar_w128(&a, STATEFUL, clip, stream);
}

}  // namespace

extern "C" {

int hm_lif_max_channels() { return BIPOLAR_MAX_C; }

// The rec == 0 layout's grid (x, y) and threads per block, as K3 and K4
// launch them: out[0..2].
void hm_lif_launch_shape(int B, int C, int N, int rec, int* out) {
  const Shape s = shape_for(B, C, N, rec);
  out[0] = (int)s.grid.x;
  out[1] = (int)s.grid.y;
  out[2] = s.threads;
}

// K3/K4's pack pass: (T, B, C) masks -> (B, Tp) mask words (32 bits where
// 2C <= 32, 64 where 2C <= 64, else 128), (B, Tp) slots, (B, Tp / PACK_T)
// most set bits a tile.
int hm_lif_pack_bipolar(const uint8_t* kp, const uint8_t* kn, void* words,
                        unsigned long long* slots, int* most, int T, int Tp, int B, int C,
                        void* stream) {
  if (C < 1 || C > BIPOLAR_MAX_C || Tp % PACK_T != 0 || Tp < T) return (int)cudaErrorInvalidValue;
  if (Tp == 0 || B == 0) return 0;
  if (2 * C <= 32) return launch_pack<uint32_t>(kp, kn, words, slots, most, T, Tp, B, C, (cudaStream_t)stream);
  if (2 * C <= 64) return hm_lif_pack_w64(kp, kn, words, slots, most, T, Tp, B, C, stream);
  return hm_lif_pack_w128(kp, kn, words, slots, most, T, Tp, B, C, stream);
}

int hm_lif_max_rec_neurons() { return NT_MAX; }

// K3
int hm_lif_count_bipolar(const void* words, const unsigned long long* slots, const int* most,
                         const int* w_in, const int* dash_syn, const int* dash_mem, const int* thr,
                         int* counts, int T, int Tp, int B, int C, int N, int rec, int clip,
                         void* stream) {
  const BipolarArgs a{words,   slots,   most,    w_in,    dash_syn, dash_mem, thr,
                      nullptr, nullptr, nullptr, counts,  nullptr,  nullptr,  nullptr,
                      T,       Tp,      B,       C,       N,        rec};
  return dispatch_bipolar<false>(a, clip, stream);
}

// K4
int hm_lif_count_stateful_bipolar(const void* words, const unsigned long long* slots,
                                  const int* most,
                                  const int* w_in, const int* dash_syn, const int* dash_mem,
                                  const int* thr, const int* isyn0, const int* vmem0,
                                  const int* spk0, int* counts, int* isyn_out, int* vmem_out,
                                  int* spk_out, int T, int Tp, int B, int C, int N, int rec,
                                  int clip, void* stream) {
  const BipolarArgs a{words,  slots,    most,     w_in,    dash_syn, dash_mem, thr,
                      isyn0,  vmem0,    spk0,     counts,  isyn_out, vmem_out, spk_out,
                      T,      Tp,       B,        C,       N,        rec};
  return dispatch_bipolar<true>(a, clip, stream);
}

}  // extern "C"
#endif  // HM_LIF_WORD_TU
