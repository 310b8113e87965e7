"""Hopper roofline harness: the port's counterpart of the TPU harness
``experiments/vpu_roofline.py:314-459``, on the card only.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m haghighatshoarmuir2024_tpu_torch.experiments.roofline [--reps N] [--batch 96]

At the flagship (bench.py's config and frames, the bundled design) it
measures:

1. P1, the integer ceiling of the LIF op mix: a sweep over chains per
   thread and launch shapes, and one reading at K3's own launch shape
   (``lif_kernel.lif_launch_shape``: one chain per thread, T steps); K3 as
   a share of the ceiling;
2. P3 at k = 2 and 4: exact against K3, and its time against K3's;
3. P2, the shift-max chains on K2/K7's tile;
4. K1-K7, K3/K4's pack pass and K5/K6's raster pack pass at their flagship
   shapes, each beside its bound.

P1 and P2 are held against their plain versions at the shapes timed.

A kernel's bound is the larger of the least operations its function needs
over their peak and its bytes (each input read once, each output written
once) over 3.35 TB/s.  The peaks are the higher of a probe's measured rate
and the CUDA Programming Guide's compute-capability-9.0 rate × the SMs × the
maximum SM clock ``nvidia-smi`` reports:

- the LIF kernels count 32-bit integer operations as P1 counts them (10 per
  neuron and step) plus one add per nonzero input and neuron, against 64
  per SM and clock or P1's ceiling.  The count is the function's, whatever
  computes it: K5/K6 make their currents on the int8 tensor cores
  (2·B·T·N·Cpad int8 operations, :func:`raster_fill_ms` at the data sheet's
  dense int8 rate), and those are not in the int32 count;
- the suppression kernels count compares: a sliding max, min or any over a
  window of L samples needs min(3, doubling steps of L) per element (van
  Herk / Gil-Werman: a prefix and a suffix scan per block of L, and one
  compare to join them), a shift one; against the guide's 64 compare,
  minimum or maximum per SM and clock, or P2's executed rate.  A round
  counts only the tiles (``suppress_kernel.TB`` samples × 32 rows) it does not skip.

Counts come from the shapes and the inputs' set bits, never from padding.
:func:`flagship_work` is the one table of what each kernel is counted for;
``chip_smoke.py`` uses it too.

Prints the card's name and power limit, then one JSON line
``{"experiment": "hopper_roofline", ...}``.  Raises without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..models.xylo.flagship import flagship_config, flagship_frames
from ..ops import peaks
from ..ops.cuda import lif_kernel as lk
from ..ops.cuda import roofline_kernel as rk
from ..ops.cuda import suppress_kernel as sk

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_TENSOR_OPS_PER_S = 1.979e15  # H100 SXM data sheet: dense int8 on the tensor cores
INT32_PER_CLK_SM = 64  # CUDA Programming Guide, cc 9.0: 32-bit integer add, shift, compare
CMP_PER_CLK_SM = 64  # CUDA Programming Guide, cc 9.0: compare, minimum, maximum
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
# the peak each kernel's operations are priced at
UNIT = {"rzcc_k1": "compares", "rzcc_k2": "compares", "suppress_k7": "compares", "probe_p2": "compares",
        "lif_pack": "int32", "lif_pack_raster": "int32", "lif_k3": "int32", "lif_k4": "int32", "lif_k5": "int32", "lif_k6": "int32",
        "probe_p1": "int32", "probe_p3": "int32"}


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline harness measures the card: no CUDA device is available")
    return torch.device("cuda", 0)


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return _smi("name,power.limit").strip()


def guide_peaks() -> dict:
    """The CUDA Programming Guide's per-clock rates × the SMs × the maximum
    SM clock ``nvidia-smi`` reports."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm").split()[0])
    clk = sms * mhz * 1e6
    return dict(sms=sms, sm_clock_mhz=mhz, int32_ops_per_s=INT32_PER_CLK_SM * clk,
                compares_per_s=CMP_PER_CLK_SM * clk)


def timed_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, ops_per_s: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, what sets them): operations over their peak or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def _against_plain(got: torch.Tensor, plain, reps: int) -> dict:
    """A kernel's output against its plain version on the same input:
    elements whose bits differ, the largest difference, and the plain
    version's time."""
    ref = plain()
    bits = torch.int32 if got.dtype == torch.float32 else got.dtype
    return dict(mismatches=int((got.view(bits) != ref.view(bits)).sum()),
                max_abs_err=float((got.double() - ref.double()).abs().max()), plain_ms=timed_ms(plain, reps))


# ------------------------------------------------------------------ ceilings
def p1_sweep(reps: int, k3_shape: tuple[int, int, int] | None = None, ops_target: float = 2e10) -> dict:
    """P1 over chains per thread × threads per block × blocks per SM, at about
    ``ops_target`` nominal operations per launch, on random int32 inputs in
    [-1000, 1000); the best rate is the ceiling, and its output is held
    against the plain version.  ``k3_shape`` = (blocks, threads, steps) adds
    the reading at K3's launch shape (:func:`k3_launch_shape`), one chain a
    thread."""
    dev = _require_cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randint(-1000, 1000, (8 * sms * 512 * 8,), generator=g, dtype=torch.int32, device=dev)
    best = dict(ops_per_s=0.0)
    for ilp in (1, 2, 4, 8):
        for threads in (128, 256, 512):
            for per_sm in (2, 4, 8):
                blocks = per_sm * sms
                n = blocks * threads * ilp
                iters = max(16, int(round(ops_target / (rk.P1_OPS_PER_STEP * n) / 16)) * 16)
                x = xs[:n]
                ms = timed_ms(lambda: rk.lif_peak(x, iters, ilp, threads, blocks), reps)
                rate = rk.P1_OPS_PER_STEP * n * iters / (ms * 1e-3)
                if rate > best["ops_per_s"]:
                    best = dict(ops_per_s=rate, ms=ms, ilp=ilp, threads=threads, blocks=blocks, iters=iters,
                                n=n, ops=rk.P1_OPS_PER_STEP * n * iters)
    x = xs[:best["n"]]
    got = rk.lif_peak(x, best["iters"], best["ilp"], best["threads"], best["blocks"])
    best.update(_against_plain(got, lambda: rk.lif_peak_plain(x, best["iters"]), 1))
    out = dict(best=best)
    if k3_shape is not None:
        blocks, threads, steps = k3_shape
        n = blocks * threads
        x = xs[:n]
        ms = timed_ms(lambda: rk.lif_peak(x, steps, 1, threads, blocks), reps)
        out["k3_shape"] = dict(blocks=blocks, threads=threads, ilp=1, iters=steps, ms=ms,
                               ops_per_s=rk.P1_OPS_PER_STEP * n * steps / (ms * 1e-3))
    return out


def k3_launch_shape(B: int, C: int, N: int, T: int) -> tuple[int, int, int]:
    """(blocks, threads per block, steps) of K3's launch at this shape, as
    the library launches it."""
    gx, gy, threads = lk.lif_launch_shape(B, C, N)
    return gx * gy, threads, T


def p2_ceiling(w: int, reps: int, rep: int = 32, blocks_per_sm: int = 12) -> dict:
    """P2 on one (352, 32) tile per block (the tile of K2/K7's first design, which did
    such shifted reads; the kernels now work on bit words), ``blocks_per_sm`` blocks per SM:
    the compares it executes per second (one per shifted read), and its
    output against the plain version."""
    dev = _require_cuda()
    nb = blocks_per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((nb, rk.P2_TBE, rk.P2_ROWS), generator=g, device=dev)
    ms = timed_ms(lambda: rk.shiftmax(x, w, rep), reps)
    pairs = rk.shiftmax_pairs(x.shape, w, rep)
    out = dict(compares_per_s=pairs / (ms * 1e-3), ms=ms, pairs=pairs, w=w, tbe=rk.P2_TBE, rep=rep, blocks=nb,
               shape=tuple(x.shape))
    out.update(_against_plain(rk.shiftmax(x, w, rep), lambda: rk.shiftmax_plain(x, w, rep), 1))
    return out


def ceilings(reps: int, k3_shape=None, w: int = 11) -> dict:
    """P1's and P2's measured rates beside the guide's peaks; the operation
    peaks the bounds use are the higher of the two."""
    guide = guide_peaks()
    p1 = p1_sweep(reps, k3_shape)
    p2 = p2_ceiling(w, reps)
    return dict(guide=guide, p1=p1, p2=p2,
                peaks=dict(int32=max(p1["best"]["ops_per_s"], guide["int32_ops_per_s"]),
                           compares=max(p2["compares_per_s"], guide["compares_per_s"])))


# ------------------------------------------------------------------ counters
def window_compares(L: int) -> int:
    """Least compares per element of a sliding max, min or any over a window
    of L samples: the doubling chain's steps, or 3 by van Herk / Gil-Werman,
    whichever is fewer."""
    return min(3, rk.chain_len(L))


def extrema_compares(W: int) -> int:
    """Compares per element of the bounded-plateau extrema of both
    polarities: a trailing max and a leading min over W, and the shift."""
    return 2 * window_compares(W) + 1


def round_compares(w: int) -> int:
    """Compares per element of one suppression round of one polarity: the
    window max of the heights and of the winners over 2w + 1 samples, and
    the leading any over w after a shift."""
    return 2 * window_compares(2 * w + 1) + 1 + window_compares(w)


def lif_work(nnz: int, T: int, B: int, N: int, C_in: int, stateful: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one LIF count kernel: 10 per neuron and step,
    one per nonzero input and neuron; the (T, B, C_in) one-byte inputs, the
    int32 weights and per-neuron integers, the counts, and for K4/K6 the
    three state arrays in and out."""
    ops = rk.P1_OPS_PER_STEP * T * B * N + nnz * N
    nbytes = T * B * C_in + 4 * (C_in * N + 3 * N + B * N) + (24 * B * N if stateful else 0)
    return float(ops), float(nbytes)


def pack_work(T: int, B: int, C: int) -> tuple[float, float]:
    """(operations, bytes) of K3/K4's pack pass, as its function needs them:
    per step, row and channel a test of each mask, an and-not and an or into
    the word; the two (T, B, C) one-byte masks in and per step and row one
    mask word out (4 bytes where 2C <= 32, 8 where 2C <= 64, else 16).  The slots and the most
    set bits the kernel also writes are its design's, not its function's:
    the bound leaves them out."""
    word = 4 if 2 * C <= 32 else 8 if 2 * C <= 64 else 16
    return float(4 * T * B * C), float(2 * T * B * C + word * T * B)


def pack_raster_work(T: int, B: int, C: int) -> tuple[float, float]:
    """(operations, bytes) of K5/K6's raster pack pass: one move per 32-bit
    word written; the (T, B, C) one-byte raster in and its (B, T, Cpad) copy
    out, Cpad = C rounded up to the mma's k-tile."""
    c_pad = lk.padded_channels(C)
    return float(T * B * c_pad // 4), float(T * B * C + T * B * c_pad)


def raster_fill_ms(T: int, B: int, C: int, N: int) -> float:
    """Least milliseconds of K5/K6's tensor-core fill alone: the int8
    multiply-adds of the (B·T, Cpad) × (Cpad, N) product, two operations
    each, over the data sheet's dense int8 rate."""
    c_pad = lk.padded_channels(C)
    return 2.0 * B * T * N * c_pad / INT8_TENSOR_OPS_PER_S * 1e3


def lifted_iir_work(T: int, L: int, SB: int, N: int, Q: int, w2_terms: int | None) -> tuple[float, float]:
    """(float32 operations, bytes) of ``csrc/iir_lifted.cu`` on (T, L): two
    operations a multiply-add.  Per block of SB samples and column, the N + 1
    increment rows and the assembly's products: G2's lower triangle (its
    upper one is zero), SB (SB + 1) / 2, and SB × N; at level 2
    (``w2_terms``, the level-2 multiply-adds a super-block and column: each
    row tile's rows times its columns up to its last nonzero one) the level-2
    products and the recurrence's h1m·U, Ps·s and Hc·s a block, ASBQ·s and
    sum_h·s a super-block; at level 1 (None) ASB·s and h1·s a block.  Bytes:
    x read and z written once, the carried state in and out."""
    nb = -(-T // SB)
    fma = nb * ((N + 1) * SB + SB * (SB + 1) // 2 + SB * N)
    if w2_terms is None:
        fma += nb * (N * N + N)
    else:
        fma += (nb // Q) * (w2_terms + N * N + N) + nb * (N + N * N + N)
    return 2.0 * fma * L, 4.0 * (2 * T * L + 2 * L * (N + 1))


def matched_work(B: int, K: int, G: int) -> tuple[float, float]:
    """(float32 operations, bytes) of ``csrc/matched.cu``: a frame's mean
    and centring (2K), its G dot products of K multiply-adds; the rates and
    the table read once, the scores written once."""
    return float(B * (2 * K + 2 * G * K)), 4.0 * (B * K + G * K + B * G)


def k1_work(T: int, R: int, w: int, W: int) -> tuple[float, float]:
    """(compares, bytes) of K1: the extrema and one round of both polarities
    over every element; cs in, four masks out."""
    return float((extrema_compares(W) + 2 * round_compares(w)) * T * R), float(T * R * (4 + 4))


def live_elements(act: torch.Tensor, w: int) -> int:
    """Elements of the TB × 32 tiles of a (T, R) candidate mask that hold a
    candidate within their halo ``_margin(w)``: the tiles a round of K2/K7
    does not skip."""
    T, R = act.shape
    tb, rb, M = sk.TB, 32, sk._margin(w)
    nt, nr = -(-T // tb), -(-R // rb)
    rows = torch.zeros((nr * rb, T), dtype=torch.bool, device=act.device)
    rows[:R] = act.T
    any_t = rows.reshape(nr, rb, T).any(dim=1).to(torch.int32)  # (nr, T)
    csum = torch.nn.functional.pad(torch.cumsum(any_t, dim=1), (1, 0))
    t0 = torch.arange(nt, device=act.device) * tb
    lo, hi = (t0 - M).clamp(0, T), (t0 + tb + M).clamp(0, T)
    live = (csum[:, hi] - csum[:, lo]) > 0  # (nr, nt)
    span_t = (torch.minimum(t0 + tb, torch.tensor(T, device=act.device)) - t0).to(torch.int64)
    span_r = (torch.minimum(torch.arange(nr, device=act.device) * rb + rb, torch.tensor(R, device=act.device))
              - torch.arange(nr, device=act.device) * rb).to(torch.int64)
    return int((live.to(torch.int64) * span_r[:, None] * span_t[None, :]).sum())


def round_work(acts, w: int, new_kept: int) -> tuple[float, float]:
    """(compares, bytes) of one suppression round over the candidate masks
    ``acts`` (one per polarity): compares over the live tiles of each; the
    masks in and out, the heights of the live tiles, the new kept bits."""
    T, R = acts[0].shape
    compares = bytes_h = 0
    for a in acts:
        live = live_elements(a, w)
        compares += round_compares(w) * live
        bytes_h = max(bytes_h, 4 * live)  # both polarities read the same cs
    return float(compares), float(2 * len(acts) * T * R + bytes_h + new_kept)


def p2_work(shape, w: int, rep: int) -> tuple[float, float]:
    """(compares, bytes) of P2's function: ``rep`` sliding maxes and mins
    over w + 1 samples per element; the tile in and out."""
    n = 1
    for d in shape:
        n *= int(d)
    return float(2 * rep * window_compares(w + 1) * n), float(8 * n)


def rzcc_work(cs_tm, w: int, W: int) -> dict:
    """{kernel: (operations, bytes)} of K1 on ``cs_tm`` (T, rows) and of one
    K2 round on K1's masks, counted from the plain versions' masks."""
    T, R = cs_tm.shape
    k1 = sk._k1_plain(cs_tm, w, W)
    k2 = sk._k2_plain(cs_tm, *k1, w)
    new_kept = int(k2[2].sum() + k2[3].sum() - k1[2].sum() - k1[3].sum())
    return {"rzcc_k1": k1_work(T, R, w, W), "rzcc_k2": round_work((k1[0], k1[1]), w, new_kept)}


def lif_bipolar_work(kp, kn, N: int) -> dict:
    """{kernel: (operations, bytes)} of K3/K4's pack pass, K3 and K4 on the
    (T, B, C) polarity masks ``kp``/``kn`` and N neurons, as their function
    needs them (the masks read once): the flagship's C = 14 and the
    three-band model's C = 42 alike."""
    T, B, C = kp.shape
    nnz = int((kp & ~kn).sum()) + int(kn.sum())
    return {
        "lif_pack": pack_work(T, B, C),
        "lif_k3": lif_work(nnz, T, B, N, 2 * C),
        "lif_k4": lif_work(nnz, T, B, N, 2 * C, stateful=True),
    }


def flagship_work(cs_tm, w: int, W: int, kp, kn, u_spikes, N: int, p1: dict, p2: dict) -> dict:
    """{kernel: (operations, bytes)} of each kernel's timed launch at the
    flagship, counted from its inputs: K1 on ``cs_tm`` (T, rows); K2 on K1's
    masks; K3/K4 and P3 on the (T, B, C) polarity masks ``kp``/``kn``; K5/K6
    on the unipolar (T, B, C) int8 raster (K3/K4 counted as their function
    needs, the masks read once; the pack pass they run first has its own
    entry, and so has K5/K6's raster pack pass); K7's first round on the maxima of ``cs_tm`` with heights
    ``cs_tm``; P1 at the sweep's best point ``p1``; P2 on its tiles ``p2``.
    Masks come from the plain versions."""
    T, _ = cs_tm.shape
    _, B, _ = kp.shape
    maxima = peaks.local_extrema_mask_bounded(cs_tm.T, W)[0].T.contiguous()
    _, kept7 = sk._k7_plain(cs_tm, maxima, torch.zeros_like(maxima), w)
    u_nnz = int((u_spikes != 0).sum())
    Cu = u_spikes.shape[-1]
    lif = lif_bipolar_work(kp, kn, N)
    return {
        **rzcc_work(cs_tm, w, W),
        **lif,
        "lif_pack_raster": pack_raster_work(T, B, Cu),
        "lif_k5": lif_work(u_nnz, T, B, N, Cu),
        "lif_k6": lif_work(u_nnz, T, B, N, Cu, stateful=True),
        "suppress_k7": round_work((maxima,), w, int(kept7.sum())),
        "probe_p1": (float(p1["ops"]), 8.0 * p1["n"]),
        "probe_p2": p2_work(p2["shape"], p2["w"], p2["rep"]),
        "probe_p3": lif["lif_k3"],
    }


def bounds(work: dict, peaks_per_s: dict) -> dict:
    """{kernel: (bound ms, "operations" or "bytes")} of :func:`flagship_work`
    at the peaks of :func:`ceilings`."""
    return {name: bound(ops, peaks_per_s[UNIT[name]], nbytes) for name, (ops, nbytes) in work.items()}


# ------------------------------------------------------------------ flagship
def p3_against_k3(config, kp, kn, reps: int) -> dict:
    """P3 at k = 2 and 4 against K3 on the same masks: the largest count
    difference and the times."""
    ref = lk.lif_count_rates_bipolar(config, kp, kn, spike_bound=1)
    out = dict(k3_ms=timed_ms(lambda: lk.lif_count_rates_bipolar(config, kp, kn, spike_bound=1), reps))
    for k in (2, 4):
        got = rk.lif_count_kstep(config, kp, kn, k)
        out[f"k{k}_max_abs_err"] = int((got.long() - ref.long()).abs().max())
        out[f"k{k}_ms"] = timed_ms(lambda k=k: rk.lif_count_kstep(config, kp, kn, k), reps)
    return out


def run(reps: int, batch: int) -> dict:
    """Every measurement of the harness at the flagship; milliseconds are
    device time by CUDA events."""
    from ..models.xylo import Demo

    dev = _require_cuda()
    demo = Demo(**flagship_config(dev))
    frames, _ = flagship_frames(demo, batch)
    cs = demo.encode(frames)  # (T, B, C)
    T, B, C = cs.shape
    N = demo.xylo_config.w_in.shape[1]
    cs_tm = cs.reshape(T, B * C)
    w, W = sk._windows(demo.robust_width, 2 * demo.robust_width)
    kp, kn = demo.rzcc(cs)
    udemo = Demo(**flagship_config(dev, bipolar=False), use_cache=False)  # designed on the card
    u_spikes = udemo.rzcc(udemo.encode(frames))[0].to(torch.int8)
    cfg, ucfg = demo.xylo_config, udemo.xylo_config

    ceil = ceilings(reps, k3_shape=k3_launch_shape(B, C, N, T), w=w)
    p3 = p3_against_k3(cfg, kp, kn, reps)
    work = flagship_work(cs_tm, w, W, kp, kn, u_spikes, N, ceil["p1"]["best"], ceil["p2"])
    zeros = lambda: tuple(torch.zeros((B, N), dtype=torch.int32, device=dev) for _ in range(3))  # noqa: E731

    # the timed launches, as flagship_work counts them
    k1 = sk.rzcc_k1(cs_tm, w, W)
    maxima = peaks.local_extrema_mask_bounded(cs_tm.T, W)[0].T.contiguous()
    kept7 = torch.zeros_like(maxima)
    first = lk.lif_count_stateful_bipolar(cfg, kp, kn, *zeros())
    kp2, kn2 = kp.flip(0).contiguous(), kn.flip(0).contiguous()  # a second chunk from the first's state
    u_first = lk.lif_count_stateful(ucfg, u_spikes, *zeros(), spike_bound=1, time_major=True)
    u2 = u_spikes.flip(0).contiguous()
    ms = {
        "rzcc_k1": timed_ms(lambda: sk.rzcc_k1(cs_tm, w, W), reps),
        # repeating the round on the same masks sets the same kept bits again
        "rzcc_k2": timed_ms(lambda: sk.rzcc_k2(cs_tm, *k1, w), reps),
        "lif_pack": timed_ms(lambda: lk.pack_bipolar_masks(kp, kn), reps),
        "lif_pack_raster": timed_ms(lambda: lk.pack_raster(u_spikes), reps),
        "lif_k3": p3["k3_ms"],
        "lif_k4": timed_ms(lambda: lk.lif_count_stateful_bipolar(cfg, kp2, kn2, *first[1:]), reps),
        "lif_k5": timed_ms(lambda: lk.lif_count_rates(ucfg, u_spikes, time_major=True, spike_bound=1), reps),
        "lif_k6": timed_ms(lambda: lk.lif_count_stateful(ucfg, u2, *u_first[1:], spike_bound=1,
                                                         time_major=True), reps),
        "suppress_k7": timed_ms(lambda: sk.suppress_k7(cs_tm, maxima, kept7, w), reps),
        "probe_p1": ceil["p1"]["best"]["ms"],
        "probe_p2": ceil["p2"]["ms"],
        "probe_p3": p3["k4_ms"],
    }
    kernels = {}
    for name, (b_ms, by) in bounds(work, ceil["peaks"]).items():
        ops, nbytes = work[name]
        kernels[name] = dict(ms=ms[name], ops=ops, unit=UNIT[name], bytes=nbytes, bound_ms=b_ms, bound_by=by,
                             share=b_ms / ms[name])
    return dict(card=card_line(), batch=B, T=T, rows=B * C, neurons=N, guide=ceil["guide"], p1=ceil["p1"],
                raster_fill_bound_ms=raster_fill_ms(T, B, u_spikes.shape[-1], N),
                p2=ceil["p2"], peaks=ceil["peaks"], p3=p3, kernels=kernels,
                select_by_distance_tm_ms=timed_ms(lambda: sk.select_by_distance_tm(maxima, cs_tm, w + 1), reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    out = run(args.reps, args.batch)
    print(out.pop("card"), flush=True)
    print(json.dumps({"experiment": "hopper_roofline", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
