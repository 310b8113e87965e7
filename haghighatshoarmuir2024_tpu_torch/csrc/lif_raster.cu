// Integer-LIF spike counts for Hopper (sm_90a) from one int8 spike raster:
// kernels K5 and K6 and their pack pass.  K3 and K4, from the two RZCC
// polarity masks, are in lif.cu; the dynamics and the two launch layouts
// (rec == 0, rec != 0) that all four share are set out in lif_common.cuh.
//
// K5 replaces the Pallas kernel _lif_kernel of
// haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:76 (public entry
// lif_count_rates, :218) and K6 _lif_kernel_stateful (:666, public entry
// lif_count_stateful, :802), K5 with the (B, N) isyn/vmem/spk state loaded
// at the start and stored at the end: the input current is the product of
// an int8 raster of any values (multi-count, negative) with w_in, as the
// Pallas body's int8 x int8 -> int32 product (:106-115).
//
// The same bound as K3/K4's, operations (0.175-0.178 ms at the unipolar
// flagship, B = 96, T = 12 000, C = 14, N = 449, 586 k nonzeros), and the
// same first design:
// 1.37 ms, of which the byte staging 0.38-0.70 and the step loop's bit scan
// with its dependent loads 0.37-0.70 (PERF.md §6, NVIDIA H100 80GB HBM3,
// 700 W).  A raster's values are any int8 and C goes to 128, so instead of
// slots the design here computes the currents as the Pallas body does
// (lif_kernel.py:106-115): one int8 x int8 -> int32 matrix product ahead of
// the step loop, on the tensor cores, which the chain leaves idle.
//
//   pack   lif_pack_raster_kernel reads the (T, B, C) raster once, coalesced,
//          as 32-bit words, and writes row-major (B, Tp, Cpad) int8: a step's
//          channels side by side, zero-padded to whole k-tiles of 16, so that
//          an mma fragment of the raster is one aligned word a thread.  K5's
//          and K6's times include it.
//   fill   a warp owns 32 neurons of one batch row.  Per group of 16 steps it
//          computes their (32 x 16) currents as 2 x 2 x ceil(C / 16)
//          mma.sync.m16n8k16 (weights as A, 16 neurons x 16 channels; the
//          raster as B, 16 channels x 8 steps), written by hand as inline
//          PTX.  The weights arrive as fragments made on the host once a
//          config (ops/cuda/lif_kernel.weight_fragments): int8 weights stay
//          in registers, four a k-tile, in kernels for one, two, up to four
//          and up to eight k-tiles; weights outside int8 are two to four
//          byte planes (the top one signed, the lower ones unsigned: mma
//          takes u8 x s8) summed by Horner's rule in the accumulator, exact
//          in wrapping int32, and are read each group through the read-only
//          cache, as all weights are when rec != 0.  Density and values
//          change nothing per step; the k-tiles do.  At the flagship's size
//          (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W): 0.33 ms at C = 14, 0.38
//          at 28, 0.49 at 33 and 42, 0.51 at 64, 0.66 at 84, 0.93 at 128.
//          Registers are what keeps the fill off the chain's pace: the same
//          int8 weights read each group took 0.77 ms at C = 14, 0.87 at 33
//          and 1.55 at 128, and two byte planes at C = 14 take 1.07.
//   chain  the accumulators cross to one neuron a lane through the warp's tile
//          in shared memory.  One unrolled loop per group steps the chain on
//          16 currents in registers; beside it the next group's are read from
//          the tile, before it the mma of the group after that are started and
//          after it stored; the raster's fragments are loaded one group
//          further ahead.  Nothing the chain waits on; no block barrier when
//          rec == 0.  The step itself compiles to seven machine operations:
//          the threshold's subtraction and the count are predicated on one
//          compare.  What it still pays: 35 operations a group beside the
//          chain's 112, and 11 warps an SM where 10.2 would do (PERF.md).
#include "lif_common.cuh"

namespace {

constexpr int RASTER_NT = 32;      // neurons per block when rec == 0, one warp
constexpr int RASTER_MAX_C = 128;  // input channels
constexpr int RASTER_K = 16;       // channels a k-tile of mma.m16n8k16 (int8) takes
constexpr int GROUP = 16;          // steps a fill computes, two n-tiles of the mma
constexpr int TILE_S = 20;         // words a tile row, GROUP steps and 4 of padding

// ------------------------------------------------------------ K5/K6: pack
// The raster pack pass: the (T, B, C) int8 raster becomes row-major
// (B, Tp, CW) 32-bit words, CW = 4 * ceil(C / RASTER_K): a step's channels
// as consecutive int8, zero-padded to whole k-tiles, so that the chain's
// mma A fragment is one aligned word a thread.  Steps in [T, Tp) get zeros.
//
// One block per tile of PACK_T steps x PACK_B rows, as the bipolar pack: a
// warp copies a step's tile row (the PACK_B rows' C bytes, contiguous) into
// shared memory as the aligned words that cover it, PER words a lane and
// step (S words a step, odd); then warp r writes row r's 32 steps, which
// are contiguous in the output, a word a lane at a time: each word's four
// channels come out of the staged words by one funnel shift.
template <int PER>
__global__ void lif_pack_raster_kernel(const uint8_t* __restrict__ v, uint32_t* __restrict__ packed,
                                       int T, int Tp, int B, int C, int CW, int S) {
  constexpr int STEPS = PACK_T / PACK_B;  // step rows per warp
  extern __shared__ uint32_t s_v[];       // (PACK_T, S)
  const int lane = threadIdx.x, r = threadIdx.y;
  const int t0 = blockIdx.x * PACK_T, b0 = blockIdx.y * PACK_B;
  const int rows = min(PACK_B, B - b0);
  const int span = rows * C;
  auto row_start = [&](int t) { return reinterpret_cast<uintptr_t>(v + ((size_t)t * B + b0) * C); };
  uint32_t x[STEPS][PER];
#pragma unroll
  for (int ii = 0; ii < STEPS; ++ii) {
    const int t = t0 + r + ii * PACK_B;
    const uintptr_t at = row_start(t);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(at & ~(uintptr_t)3);
    const int nw = (int)(((at & 3) + span + 3) >> 2);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int w = lane + 32 * k;
      x[ii][k] = t < T && w < nw ? __ldg(wp + w) : 0;
    }
  }
#pragma unroll
  for (int ii = 0; ii < STEPS; ++ii) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int w = lane + 32 * k;
      if (w < S) s_v[(r + ii * PACK_B) * S + w] = x[ii][k];
    }
  }
  __syncthreads();
  if (r >= rows) return;
  uint32_t* out = packed + ((size_t)(b0 + r) * Tp + t0) * CW;
  for (int q = lane; q < PACK_T * CW; q += 32) {
    const int i = q / CW, k = q - i * CW;  // step of the tile, word of the step
    uint32_t word = 0;
    if (t0 + i < T && 4 * k < C) {
      const int bp = (int)(row_start(t0 + i) & 3) + r * C + 4 * k;  // channels 4k.. of row r
      const uint32_t* p = s_v + i * S;
      word = __funnelshift_r(p[bp >> 2], p[(bp >> 2) + 1], 8 * (bp & 3));
      if (C - 4 * k < 4) word &= (1u << (8 * (C - 4 * k))) - 1;  // channels < C
    }
    out[q] = word;
  }
}

// ----------------------------------------------------------- K5/K6: chain
// Arguments of K5 and K6.  isyn0 == nullptr starts from zeros; the outputs
// isyn_out/vmem_out/spk_out are written only when non-null.
struct RasterArgs {
  const uint32_t* packed;  // (B, Tp, 4 KT) words: the pack pass's output
  // (ceil(N / 32), P, KT, 4, 32) words: the weights as mma A fragments.  The
  // word of warp w, byte plane p, k-tile kt, index i and lane l holds the
  // plane's bytes of w_in[16 kt + 4 (l % 4) + j, 32 w + 8 i + l / 4],
  // j = 0..3 from the low byte (m-tile i / 2, its rows l / 4 for even i and
  // l / 4 + 8 for odd); zero past C and N.  The top plane is signed, those
  // below unsigned: w = sum_p plane_p << 8 p.
  const uint32_t* w_frag;
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
  int T, Tp, B, KT, P, N, rec;
};

// D = A B + D on the tensor cores: A (16 neurons x 16 channels, row-major)
// the weights, int8 or, for the lower byte planes of wide weights, uint8; B
// (16 channels x 8 steps, column-major) the raster, int8; D int32,
// wrapping.  Lane l = 4 g + q holds A's bytes [g][4q..4q+3] in w0 and
// [g + 8][4q..4q+3] in w1, B's [4q..4q+3][g] in x, and D's [g][2q],
// [g][2q + 1], [g + 8][2q], [g + 8][2q + 1] in d[0..3].
template <bool W_SIGNED>
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t w0, uint32_t w1, uint32_t x) {
  if (W_SIGNED)
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(w0), "r"(w1), "r"(x));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(w0), "r"(w1), "r"(x));
}

// One step of one chain as lif_step, with the threshold's subtraction and
// the count predicated on one compare (the compiler's own form of lif_step
// spends a select and an add on each); for chains whose spk nobody reads
// between steps.
template <bool CLIP>
__device__ __forceinline__ void lif_step_counted(int& isyn, int& vmem, int& cnt, int cur, int ds,
                                                 int dm, int th) {
  isyn = isyn - (isyn >> ds) + cur;
  if (CLIP) isyn = min(max(isyn, STATE_MIN), STATE_MAX);
  vmem = vmem - (vmem >> dm) + isyn;
  if (CLIP) vmem = min(max(vmem, STATE_MIN), STATE_MAX);
  asm("{\n"
      ".reg .pred fired;\n"
      "setp.ge.s32 fired, %0, %2;\n"
      "@fired sub.s32 %0, %0, %2;\n"
      "@fired add.s32 %1, %1, 1;\n"
      "}"
      : "+r"(vmem), "+r"(cnt)
      : "r"(th));
}

// The shared body of K5 and K6.  A warp owns 32 neurons of one batch row
// and walks the row in groups of GROUP steps.  The fill of a group is the
// (32 neurons x 16 steps) currents as 2 m-tiles x 2 n-tiles x KT k-tiles of
// mma: the raster's fragments are two words a k-tile straight from the
// packed rows, loaded a group ahead; the accumulators go to the warp's tile
// in shared memory, [neuron][step], from which each lane reads its own
// neuron's 16 currents, four a load.  A tile row is TILE_S = 20 words: the
// 16-byte loads meet no bank twice, the mma lanes' 8-byte stores some banks
// twice, and every address is one base and a constant.
//
// KTR > 0: int8 weights (P = 1) of up to KTR k-tiles, whose fragments stay
// in registers: exactly KTR of them for KTR = 1 and 2 (every address a
// constant), else a.KT <= KTR, with zeros in the registers past a.KT, so
// that the product runs over KTR k-tiles unconditionally.  KTR == 0: any
// KT and P, the fragments read again each group through the read-only
// cache; a lower plane's product is added after the sum so far is shifted
// by 8 bits (Horner, in the accumulator itself).
//
// rec == 0: one unrolled loop per group steps the chain on currents in
// registers and, beside it, reads the next group's from the tile; before
// it the mma of the group after that are started, and after it their
// accumulators are stored.  Two sets of registers, so that nothing is
// moved; blocks of one warp, no block barrier.  rec != 0: the chains of a
// row meet in a __syncthreads_count every step, which sets the pace: fill,
// then 16 steps.
template <bool CLIP, bool REC, int KTR>
__device__ __forceinline__ void lif_raster_body(const RasterArgs& a) {
  constexpr int KA = KTR > 0 ? KTR : RASTER_MAX_C / RASTER_K;  // k-tiles of the raster held in registers
  extern __shared__ __align__(16) int smem_raster[];  // per warp a tile of (32, TILE_S) words
  const int T = a.T, N = a.N;
  constexpr bool EXACT = KTR == 1 || KTR == 2;  // KT == KTR, known to the compiler
  const int KT = EXACT ? KTR : a.KT, CW = 4 * KT;
  const int tx = threadIdx.x, lane = tx % 32, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + tx;
  const bool live = n < N;
  const size_t at = (size_t)b * N + n;
  int* tile = smem_raster + (tx / 32) * 32 * TILE_S;
  const uint32_t* steps = a.packed + (size_t)b * a.Tp * CW;
  const uint32_t* wf = a.w_frag + (size_t)(n / 32) * a.P * KT * 128 + lane;
  uint32_t wreg[KTR > 0 ? KTR : 1][4];
  if (KTR > 0) {
#pragma unroll
    for (int kt = 0; kt < KTR; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) wreg[kt][i] = EXACT || kt < KT ? __ldg(wf + (kt * 4 + i) * 32) : 0;
  }
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
    if (!REC) return lif_step_counted<CLIP>(isyn, vmem, cnt, cur, ds, dm, th);  // a dead lane stores nothing
    const bool fired = lif_step<CLIP>(isyn, vmem, cur + a.rec * row_spikes, ds, dm, th, live);
    cnt += fired ? 1 : 0;
    spk = fired ? 1 : 0;
    row_spikes = __syncthreads_count(fired);
  };
  // the raster's fragments of the group from step t0: x[kt][s] the channels
  // 16 kt + 4 q .. + 3 of step t0 + 8 s + g (the last group again past Tp:
  // the chain stops at T and never reads those)
  auto load_x = [&](uint32_t (&x)[KA][2], int t0) {
    const uint32_t* p = steps + (size_t)(min(t0, a.Tp - GROUP) + g) * CW + q;
#pragma unroll
    for (int kt = 0; kt < KA; ++kt)
      if (EXACT || kt < KT) {
        x[kt][0] = __ldg(p + 4 * kt);
        x[kt][1] = __ldg(p + 8 * CW + 4 * kt);
      }
  };
  // the currents of m-tile m (neurons 16 m .. 16 m + 15 of the warp): d[s]
  // those of steps 8 s .. 8 s + 7
  auto mma_mtile = [&](int (&d)[2][4], const uint32_t (&x)[KA][2], int m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) d[s][0] = d[s][1] = d[s][2] = d[s][3] = 0;
    if (KTR > 0) {
#pragma unroll
      for (int kt = 0; kt < KTR; ++kt)
#pragma unroll
        for (int s = 0; s < 2; ++s) mma_s8<true>(d[s], wreg[kt][2 * m], wreg[kt][2 * m + 1], x[kt][s]);
      return;
    }
    for (int p = a.P - 1; p >= 0; --p) {
      const bool top = p == a.P - 1;
      if (!top) {
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i / 4][i % 4] = (int)((unsigned)d[i / 4][i % 4] << 8);
      }
#pragma unroll
      for (int kt = 0; kt < KA; ++kt)
        if (kt < KT) {
          const uint32_t* w = wf + ((p * KT + kt) * 4 + 2 * m) * 32;
          const uint32_t w0 = __ldg(w), w1 = __ldg(w + 32);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (top)
              mma_s8<true>(d[s], w0, w1, x[kt][s]);
            else
              mma_s8<false>(d[s], w0, w1, x[kt][s]);
          }
        }
    }
  };
  auto store_mtile = [&](const int (&d)[2][4], int m) {
    int* at = tile + (16 * m + g) * TILE_S + 2 * q;  // neuron 16 m + g, steps 2 q and 2 q + 1
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      *reinterpret_cast<int2*>(at + 8 * s) = make_int2(d[s][0], d[s][1]);
      *reinterpret_cast<int2*>(at + 8 * TILE_S + 8 * s) = make_int2(d[s][2], d[s][3]);
    }
  };
  auto read4 = [&](int (&cur)[GROUP], int c) {  // this lane's currents of steps 4 c .. 4 c + 3
    const int4 v = *reinterpret_cast<const int4*>(tile + lane * TILE_S + 4 * c);
    cur[4 * c] = v.x, cur[4 * c + 1] = v.y, cur[4 * c + 2] = v.z, cur[4 * c + 3] = v.w;
  };
  auto tail = [&](const int (&cur)[GROUP], int r) {  // the last group, up to T
    int before = cnt;
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (j < r) {
        before = cnt;
        step(cur[j]);
      }
    if (!REC) spk = cnt - before;  // whether the last step fired
  };

  auto run_rec = [&]() {
    uint32_t x[KA][2] = {};
    for (int t0 = 0; t0 < T; t0 += GROUP) {
      load_x(x, t0);
      __syncwarp();  // the tile's last reads are done
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        int d[2][4];
        mma_mtile(d, x, m);
        store_mtile(d, m);
      }
      __syncwarp();
      int cur[GROUP];
#pragma unroll
      for (int c = 0; c < GROUP / 4; ++c) read4(cur, c);
      tail(cur, T - t0);
    }
  };
  auto run = [&]() {
    uint32_t x[KA][2] = {};  // k-tiles past KT stay zero
    int acc[2][2][4], ca[GROUP], cb[GROUP];
    auto mma_group = [&]() {
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_mtile(acc[m], x, m);
    };
    auto store_group = [&]() {
      __syncwarp();  // every lane has read the tile's group
#pragma unroll
      for (int m = 0; m < 2; ++m) store_mtile(acc[m], m);
      __syncwarp();
    };
    load_x(x, 0);
    mma_group();
    load_x(x, GROUP);
    store_group();
#pragma unroll
    for (int c = 0; c < GROUP / 4; ++c) read4(ca, c);
    mma_group();
    load_x(x, 2 * GROUP);
    store_group();
    // here and at each turn: the chain's currents of the group at t0 in
    // registers, those of the next group in the tile, the raster's fragments
    // of the one after that loaded
    for (int t0 = 0;; t0 += 2 * GROUP) {
      if (t0 + GROUP >= T) return tail(ca, T - t0);
      mma_group();
      load_x(x, t0 + 3 * GROUP);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j % 4 == 0) read4(cb, j / 4);
        step(ca[j]);
      }
      store_group();
      if (t0 + 2 * GROUP >= T) return tail(cb, T - t0 - GROUP);
      mma_group();
      load_x(x, t0 + 4 * GROUP);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j % 4 == 0) read4(ca, j / 4);
        step(cb[j]);
      }
      store_group();
    }
  };
  if (T > 0) {
    if (REC)
      run_rec();
    else
      run();
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

// K5: counts from a zero state.
template <bool CLIP, bool REC, int KTR>
__global__ void __launch_bounds__(REC ? NT_MAX : RASTER_NT) lif_count_kernel(RasterArgs a) {
  lif_raster_body<CLIP, REC, KTR>(a);
}

// K6: counts and the final state from a given state.
template <bool CLIP, bool REC, int KTR>
__global__ void __launch_bounds__(REC ? NT_MAX : RASTER_NT) lif_count_stateful_kernel(RasterArgs a) {
  lif_raster_body<CLIP, REC, KTR>(a);
}

template <bool STATEFUL, bool CLIP, bool REC, int KTR>
int launch_raster(const RasterArgs& a, cudaStream_t st) {
  const int threads = REC ? (a.N + 31) / 32 * 32 : RASTER_NT;
  const dim3 grid(REC ? 1 : (a.N + RASTER_NT - 1) / RASTER_NT, a.B);
  // a tile a warp: 80 KB, above the 48 KB a kernel has unasked, for a row of 1024 neurons
  const size_t smem = (size_t)threads / 32 * 32 * TILE_S * sizeof(int);
  auto kernel = STATEFUL ? lif_count_stateful_kernel<CLIP, REC, KTR> : lif_count_kernel<CLIP, REC, KTR>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The fragments stay in registers for int8 weights without recurrence: one
// k-tile (the unipolar flagship's 14 channels), two (a bipolar model's
// combined raster of 28), up to four, up to eight.  Weights outside int8
// and rows coupled by a recurrence read them each group.
template <bool STATEFUL, bool CLIP>
int launch_raster_k(const RasterArgs& a, cudaStream_t st) {
  static_assert(RASTER_MAX_C / RASTER_K == 8, "the widest fork holds every k-tile a raster can have");
  if (a.rec) return launch_raster<STATEFUL, CLIP, true, 0>(a, st);
  if (a.P > 1) return launch_raster<STATEFUL, CLIP, false, 0>(a, st);
  if (a.KT == 1) return launch_raster<STATEFUL, CLIP, false, 1>(a, st);
  if (a.KT == 2) return launch_raster<STATEFUL, CLIP, false, 2>(a, st);
  if (a.KT <= 4) return launch_raster<STATEFUL, CLIP, false, 4>(a, st);
  return launch_raster<STATEFUL, CLIP, false, 8>(a, st);
}

template <bool STATEFUL>
int dispatch_raster(const RasterArgs& a, int clip, void* stream) {
  if (a.KT < 1 || a.KT > RASTER_MAX_C / RASTER_K || a.P < 1 || a.P > 4 || a.Tp % PACK_T != 0 ||
      a.Tp < a.T)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return clip ? launch_raster_k<STATEFUL, true>(a, st) : launch_raster_k<STATEFUL, false>(a, st);
}

}  // namespace

extern "C" {

int hm_lif_max_raster_channels() { return RASTER_MAX_C; }

// K5/K6's pack pass: the (T, B, C) int8 raster -> (B, Tp, 4 KT) words, KT
// = ceil(C / 16): see lif_pack_raster_kernel.
int hm_lif_pack_raster(const uint8_t* spikes, uint32_t* packed, int T, int Tp, int B, int C,
                       void* stream) {
  if (C < 1 || C > RASTER_MAX_C || Tp % PACK_T != 0 || Tp < T) return (int)cudaErrorInvalidValue;
  if (Tp == 0 || B == 0) return 0;
  const int CW = (C + RASTER_K - 1) / RASTER_K * (RASTER_K / 4);
  // the words that cover a step's tile row at any byte offset, one more for
  // the funnel shift's high word, odd
  const int S = (((PACK_B * C + 6) >> 2) + 1) | 1;
  const dim3 grid(Tp / PACK_T, (B + PACK_B - 1) / PACK_B), block(32, PACK_B);
  const size_t smem = (size_t)PACK_T * S * sizeof(uint32_t);
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 32)
    lif_pack_raster_kernel<1><<<grid, block, smem, st>>>(spikes, packed, T, Tp, B, C, CW, S);
  else if (S <= 64)
    lif_pack_raster_kernel<2><<<grid, block, smem, st>>>(spikes, packed, T, Tp, B, C, CW, S);
  else
    lif_pack_raster_kernel<(PACK_B * RASTER_MAX_C / 4 + 3 + 31) / 32>
        <<<grid, block, smem, st>>>(spikes, packed, T, Tp, B, C, CW, S);
  return (int)cudaGetLastError();
}

// K5 on a raster packed by lif_pack_raster_kernel and weights as fragments
// (RasterArgs); KT k-tiles of 16 channels, P byte planes.
int hm_lif_count(const uint32_t* packed, const uint32_t* w_frag, const int* dash_syn,
                 const int* dash_mem, const int* thr, int* counts, int T, int Tp, int B, int KT, int P,
                 int N, int rec, int clip, void* stream) {
  const RasterArgs a{packed,  w_frag,  dash_syn, dash_mem, thr, nullptr, nullptr, nullptr, counts,
                     nullptr, nullptr, nullptr,  T,        Tp,  B,       KT,      P,       N,
                     rec};
  return dispatch_raster<false>(a, clip, stream);
}

// K6
int hm_lif_count_stateful(const uint32_t* packed, const uint32_t* w_frag, const int* dash_syn,
                          const int* dash_mem, const int* thr, const int* isyn0, const int* vmem0,
                          const int* spk0, int* counts, int* isyn_out, int* vmem_out, int* spk_out,
                          int T, int Tp, int B, int KT, int P, int N, int rec, int clip,
                          void* stream) {
  const RasterArgs a{packed,   w_frag,   dash_syn, dash_mem, thr, isyn0, vmem0, spk0, counts,
                     isyn_out, vmem_out, spk_out,  T,        Tp,  B,     KT,    P,    N,
                     rec};
  return dispatch_raster<true>(a, clip, stream);
}

}  // extern "C"
