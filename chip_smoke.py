#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``haghighatshoarmuir2024_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit:

1. device: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles ``csrc/*.cu`` with nvcc for sm_90a and loads the library;
3. K1/K2 (fused bipolar RZCC) against the plain PyTorch versions on the card,
   bit-exact: random cumsums with plateaus, exact ties, dense chains, wide
   windows, ragged shapes, the edges of the kernels' bit-word layout (T and
   tiles ending mid-word, rows in and out of the four-rows-a-word path,
   masks at an odd byte offset, candidates at t = 0 and T - 1, all-candidate
   rows beside empty rows in one warp), the widest window the shared memory
   takes (one more must raise) and the flagship ``cs``; K1 and K2 are also
   timed through the library's launch functions alone;
4. K3 (integer LIF counts: the pack pass, then the chain) against the plain
   simulator on the card, bit-exact: random and saturating configs, ragged T
   (1, 7, 9 around the chain's group of 8 steps, 513 across its stage of 512,
   12 001), the flagship
   config, the flagship masks with six set bits at the start of every chunk
   of 512 (timed too: the chain then reads six slots a step in every chunk),
   dense masks at the flagship width, C = 32 (64-bit mask words) and
   C = 1, B = 1, uint8 and int8 masks of any nonzero values, masks at an odd
   byte offset, rec_coef = -1 (C = 32, and N = 1000 in one block); the
   128-bit mask words at C = 33, 42 (the three-band model's), 63 and 64,
   dense at 64 (every chunk on the out-of-line word loop), rec_coef = -1 at
   42, and C = 65 raising ``ValueError``; the pack kernel bit-exact against
   ``pack_bipolar_masks_plain`` on every case;
5. slice: the flagship ``Demo.forward_batch(method="matched")`` at B = 96,
   T = 12 000 (bench.py's frames): every kernel's launch count (the pack
   pass's too) must rise,
   the DoAs must equal the plain path's, and ``doa-ok-frac`` must be 1.00 @5°;
   prints stage and kernel times next to the plain versions';
6. K4 (stateful integer LIF) against the plain simulator on the card,
   bit-exact on counts and final state: flagship shapes, two chunks carried
   equal to one pass of 24 000 steps, chunks of 1001, 1, 7, 9 and 3001
   steps carried equal to one pass, ragged T, dense masks, C = 32 and 1,
   B = 1, the clip path and the uniform recurrence rec_coef = -1; the pack
   kernel bit-exact on every case;
7. streaming: ``StreamingLocalizer`` over 96 streams, 4 chunks of 0.25 s
   (experiments/serving_throughput.py's set-up): K1, K2, the pack pass and
   K4 must launch,
   spikes and counts must equal the same steps with the plain RZCC and LIF,
   and ``doa-ok-frac`` must be 1.00 @5° (matched); prints the step time,
   serving audio-sec/sec and the single-stream latency;
8. serving: ``LocalizationServer`` (96 slots, 0.25 s chunks) with 8 TCP
   clients of 8 chunks each, on the f32 wire and on the u4 wire at fs/4:
   K1, the pack pass and K4 must launch; every answer must arrive and equal
   the DoA of the direct streaming step on the same chunks; prints ms per
   serve step;
9. design: the bipolar flagship designed on the card (``use_cache=False``)
   must match the bundled ``bf_0`` per column up to a unit phase to within
   1e-4; the calibration profiles computed on the card from the bundled
   design are held against the bundled table, and the slice's matched gate
   must pass with them;
10. unipolar: the unipolar flagship designs and calibrates itself on the
    card; ``forward_batch(method="matched")`` on the 96 frames must launch
    K1, K2, the raster pack pass and K5 (once each), give the plain path's
    DoAs and a doa-ok-frac @5° not below the JAX package's on the same
    frames less one frame;
11. K5 (integer LIF counts from one int8 raster: the raster pack pass, then
    the tensor-core fill and the chain) against the plain simulator on the
    card, bit-exact: the unipolar flagship masks, the bipolar combined
    raster, multi-count values on the clip path, negative values, C = 84
    and C = 128, ragged T, rec_coef = -1, B = 3; C = 1, 31, 32, 33, 64, 65
    around the k-tiles of 16 channels, a bool raster, the values -128 and
    127, weights of magnitude 127 and 128 (one int8 plane, then two byte
    planes), within and beyond int16, T = 15, 16, 17 around the group of 16
    steps, rec_coef = -1 at N = 1000 and C = 128 (the most shared memory), a
    raster at an odd byte offset, and a dense multi-valued raster of the
    flagship's size (timed too); the raster pack kernel bit-exact against
    ``pack_raster_plain`` on every case; the bipolar flagship's combined
    raster of all rows through K5 must give K3's counts (timed beside K3);
    timed only, at the flagship's size: int8 weights of 42, 64, 84 and 128
    channels (the fragments in registers), two byte planes (the fragments
    read again each group), and, for the raster
    pack's ``library_ms``, ``torch.nn.functional.pad`` of the transposed
    raster, the one PyTorch call of its function (held equal to it);
12. forward: ``Demo.forward`` on single frames, bipolar and unipolar: one
    raster pack and one K5 launch per frame, the rate equal to
    ``forward_batch``'s row; prints the single-frame latency;
13. K6 (stateful K5) bit-exact on counts and final state: flagship from zero
    and carried, two chunks carried = one pass, ragged T, the clip path from
    a saturated state, rec_coef = -1; C = 33 and 65 with negative values, a
    bool raster, two byte planes, chunks of 15, 16, 17 and 1 steps carried
    equal to one pass, rec_coef = -1 at N = 1000 and C = 128 carried;
14. unipolar streaming: 96 streams x 4 chunks: the raster pack pass and K6
    launch once per chunk, spikes and counts equal the plain RZCC + plain K6
    steps;
15. K7 (one-plane suppression behind ``select_by_distance_tm``) and
    ``rzcc_select_bipolar_tm`` (on K2) bit-exact against ``select_by_distance``
    on the card: random cumsums, dense chains across tiles, exact ties,
    ragged shapes, empty, the bit-word layout's edges as in phase 3, wide
    windows up to the widest the shared memory takes (one more raising), and the
    flagship ``cs`` maxima, where K7's kept mask must equal
    ``rzcc_encode_bipolar_tm``'s ``kept_pos`` and ``rzcc_select_bipolar_tm``
    both of its outputs; the K7 launches of one ``select_by_distance_tm`` call
    on the flagship maxima are counted;
16. the roofline probes: P1 and P2 bit-exact against their plain versions at
    small sizes, P3's counts equal to K3's at the flagship (k = 2, 4) and
    on a ragged case;
17. one short run of the roofline harness's measurements
    (``haghighatshoarmuir2024_tpu_torch.experiments.roofline``): P1's and
    P2's ceilings beside the guide's peaks, P1 at K3's launch shape, P3 at
    k = 2 and 4 against K3; every kernel's bound and share of it;
18. 24 kHz: the flagship at ``fs=24_000`` on its bundled design and table,
    bench.py's frames decimated by ``decimate_fir(x, 2)``:
    ``forward_batch(method="matched")`` (K1, the pack pass and K3 once; DoAs
    = the plain path's; doa-ok-frac 1.00 @5°) and the 96-stream step over
    two carried 6000-sample chunks (lifted block 48; spikes, counts and
    state = the plain path's and = one K4 pass over both chunks' masks; the
    gate); batch and step times;
19. three bands (``experiments/multiband_bench.py``'s config: 1600-2000,
    2000-2300, 2300-2600 Hz, 449-point grid, C = 42, N = 1347) at 48 and at
    24 kHz: designed on the card (``use_cache=False``, timed), calibrated
    folded and band-stacked from the wideband template; ``forward_batch``
    with ``matched`` (gate 1.00 @5°), ``peak`` (its ok-fraction @25°
    printed, ungated as phase 5's), ``matched_stacked`` and
    ``matched_auto``, the frames outside each tolerance listed, every DoA =
    the plain path's
    (the plain LIF 32 rows at a time, over all 96 rows); K1/K2 at R = 4032,
    the pack pass and K3 at C = 42, N = 1347 bit-exact; one 96-stream step
    (K4) bit-exact in spikes, counts and state; at 48 kHz one daemon round
    by ``matched_stacked`` (answers = the direct step's); the set bits K3
    meets, its times against K5 on the combined raster, and each kernel's
    bound at F = 3 (``experiments/roofline.rzcc_work`` and
    ``lif_bipolar_work``); then ``experiments/multiband_bench.run`` on this
    model and these frames (K1, K2, the pack and K3 launched; doa-ok-frac
    1.00 @5deg matched; 20 timed calls);
20. the classical families at the flagship's width (7 mics, 48 kHz, 0.25 s
    frames, 1600-1900 Hz, 449 DoAs): the Hilbert beamformer designed on the
    card, plain and with interference removal (seconds printed); bench.py's
    96 frames through ``Beamformer.apply_to_signal``, ``MUSIC.beamforming``
    (Bartlett, 2 active bins, nfft 2048) and batched ``SRPPHAT``: the
    profiles equal the port's CPU path on the same frames within each
    family's stated tolerance, the DoAs equal where the CPU profile's top-two
    margin exceeds it and within a grid step elsewhere, the folded error
    within the family's JAX test threshold; ms per frame batched and alone,
    and the per-sample scan's share; two tones through MUSIC with
    ``num_sources=2``, ``top_k_peaks`` and ``MultiDoaTracker``: two confirmed
    tracks within 5 deg of the sources; ``tools.localize.main`` on a
    7-channel wav written from a seed, each model with ``--track``, music and
    xylo with ``--sources 2``: JSON lines well formed, every frame within 5
    deg (folded), xylo's K1, K2, pack and K3 launched, ms per frame of each
    estimator; one daemon round with ``sources=2, track=True`` over two TCP
    streams of two tones: every K-float answer equal to the direct step +
    top-K + tracker, K1, K2, pack and K4 launched, the final tracks within 25
    deg (folded) of each stream's two sources;
21. the Xylo deployment (after the main path's times): ``XyloSim`` on the
    flagship's rasters (``spike_encoding`` of 25 of bench.py's frames, T =
    12 000, N = 449), record=True, in all four step conventions with the
    flagship's uniform ``w_rec`` and with the dense push-to-hidden block
    ``w_rec`` ``[[0, W], [0, R]]`` (W the truncated flagship projection, R a
    sparse random stage-2 recurrence from the seed, since the truncation
    zeroes the flagship's own): spikes, ``Isyn``, ``Vmem``, the readout,
    ``synops`` and the states bit-exact against the CPU path, and the block
    run equal to ``XyloSimPushToHidden``'s two stages; ``spike_encoding``
    equal to the CPU path on the same ``cs`` (and within 1e-3 of the spikes
    from the same audio), ``xylo_process`` equal, ``Demo.forward(matched)``'s
    DoA equal to ``forward_batch(matched)``'s (K1, K2, the raster pack and K5
    launched); ``experiments/target_push_to_hidden`` at its reference
    configuration (designed on the card; the power workload's rasters and
    ``estimate_power`` equal to the CPU path's; 8 trials' MAE printed);
    ``experiments/target_xylo_localization.run`` at full size (1000-2000 Hz,
    grid 112, 100 trials x 11 SNRs, both estimators; gates: matched MAE <= 4
    deg and reference <= 15 deg at every SNR; JAX's records printed beside),
    its convention envelope at 25 trials, and one batch of 100 trials (the
    sweep's) at 0 dB whose DoAs equal the CPU path's on the same DoAs and
    noise (K1, K2, pack and K3 launched a batch) and whose counts from the
    card's ``cs`` through K1 -> K2 -> pack -> K3 equal the plain path's on the
    CPU, count by count;
22. the paper's other harnesses (``haghighatshoarmuir2024_tpu_torch/
    experiments/``) at the JAX harnesses' sizes: the MAE-vs-SNR sweeps of the
    Hilbert beamformer, MUSIC, the float SNN (bandwidth-corrected SNRs) and
    SRP-PHAT (tone and chirp), 100 trials x 11 SNRs on a 224-point grid, each
    at -10 and 20 dB within one grid step of what the JAX package's harness
    prints today (its own draws, on the CPU), and one 0 dB batch of each on
    the same DoAs and noise held against the CPU path on the same design
    (rows within the family's tolerance of their peak, DoAs equal where the
    top-two margin exceeds it, a grid step elsewhere; the SNN's on the same
    spikes, the card's RZCC raster, its spikes from the same frames counted);
    the speech sweeps (20 trials, at -10, 5 and 20 dB) gated finite; the three
    array-resolution harnesses (every Hilbert design and the SNN's at 2 kHz on
    each array = the CPU path's per column up to a unit phase within 1e-4;
    widths printed); multiple_targets (``hilbert_ir`` and ``music_ns2`` within
    5 deg of +-60, every row within a grid step of JAX's); moving_target
    (medians within a grid step of JAX's; K1, the raster pack and K5 launched
    once a frame, K2 at least once; the Xylo DoAs equal to the CPU path's
    ``Demo.forward`` frame by frame, and the counts through K1 -> K2 -> raster
    pack -> K5 at B = 1 from the card's ``cs`` equal to the plain path's);
    multi_target_tracking (identity held, tracked MAE within a grid step of
    JAX's); mismatch_robustness at 20 trials (every row within one 112-grid
    step of JAX's; K1, the pack and K3 once a batch, K2 at least once; each
    batch's matched DoAs equal to the CPU path's, and its counts through K1 ->
    K2 -> pack -> K3 from the card's ``cs`` equal to the plain path's); each
    harness's seconds and the per-sample scans' share of a batch, timed
    inside it;
23. the harnesses that time and check the ported paths, and the reverberant
    room (``haghighatshoarmuir2024_tpu_torch/experiments/``), at the JAX
    harnesses' sizes, each run with the launch counts set to 0 just before
    it and read just after (every kernel of its path must launch), every
    accuracy within one step of the harness's grid of what the JAX
    package's harness prints today on the CPU (its own draws):
    ``flagship_attribution`` on the flagship model and bench.py's frames
    (nested prefixes of ``forward_batch`` by CUDA events, three rounds of 50
    calls; the stages measured alone sum to ``forward_batch(matched)``
    within the readings' spread; DoAs = phase 5's, 1.00 @5deg);
    ``serving_throughput`` main (96 streams, 100 steps; 1.00 @5deg; two
    steps on its chunks = the plain step in spikes, counts, state and DoAs;
    ``--sources=2`` printed) and ``daemon_main`` over TCP on the f32, i16,
    u8 and u4 wires and u8/u4 at fs/4, over shared memory on i16 and u4 at
    fs/4 (64 clients, 20 rounds; 1.00 @5deg; every answer = the direct step
    on the decoded wire chunks), and ``--sources=2`` (two DoAs an answer,
    its fraction printed); ``reduced_rate`` at 48, 24 and 12 kHz and
    ``--band=hi`` at 48 and 24 kHz (25 trials at 0 and 10 dB, 113 points,
    each designed on the card; matched and peak MAE gated; the B = 96
    throughput); ``wire_accuracy`` (20 trials x 3 SNRs x 6 wires);
    ``snn_localization_benchmark`` (200 samples of 0.4 s frames, T = 19
    200, 449 points, peak; the run's statistics and the six sway
    conditions gated; the saved run analysed by
    ``analyse_array_localization``); ``reverb_robustness`` (20 trials x 5
    reflection coefficients, 112 points; K1, the pack and K3 once a
    batch); ``phase_analysis`` (within 1e-3 relative); ``design_time_probe``
    (printed).  The kernel shapes no earlier phase checks are held against
    a CPU twin of each harness's model, read back from the temporary
    design cache: the same integers, the same DoAs from the same frames,
    and the counts of the card's ``cs`` through K1 -> K2 -> pack -> K3 equal
    to the plain path's, count by count: reduced_rate at 12 kHz (B = 25,
    T = 3000, N = 113; dash printed), wire_accuracy (20, 12 000, 113), the
    live benchmark (20, 19 200, 449) and reverb_robustness (20, 12 000,
    112);
24. the speech harnesses, the STHT analysis and the single stream
    (``haghighatshoarmuir2024_tpu_torch/experiments/``), on whatever
    ``speech_template`` finds (the synthetic fallback unless the LibriSpeech
    sample is present), each run with the launch counts set to 0 just before
    it and read just after: ``target_xylo_localization.run_speech`` bipolar
    (100 trials x 11 SNRs, 112 points, 1.0 s trials; stage C at four SNRs)
    and unipolar (20 trials), ``multiband_speech.run`` and
    ``run_cross_segment`` (50 trials, chunks of 16, one band against three:
    C = 42, N = 336), ``xylo_ordering_sensitivity --speech`` cut to 10
    trials at 10 dB (its simulator is a host-bound loop of 12 000 steps a
    convention) and ``short_hilbert_transform``; every MAE column within one
    grid step of the mean of what the JAX package's harness prints today at
    seeds 0 and 1 (its own draws, on the CPU), widened by the larger of half
    the two seeds' spread and four standard errors of the card's mean
    against theirs (from JAX's per-trial deviation); stage A (the same numpy
    noise) within a grid step of JAX's (the unipolar model's peak error only:
    its matched errors follow the design's rounding) and its sidelobe within
    0.5 dB; the STHT's errors within 1e-4 of JAX's and the RZCC count equal.
    Each harness's model is held to its CPU twin, the card's design and
    tables read back from the temporary design cache: stage A's four frames
    of both ``run_speech`` models and the ordering harness's ten frames give
    the card's DoAs there, DoA by DoA and convention by convention (the
    ordering harness's MAEs are printed beside JAX's), and one trial batch of
    each harness at 0 dB (10 dB for the ordering harness) from the card's
    ``cs`` gives the card's masks, counts and DoAs: K1/K2's masks at (T, R) =
    (48 000, 280), (48 000, 672) and (12 000, 140), and the counts of K3 at
    (B, T, C, N) = (20, 48 000, 14, 112) and (16, 48 000, 42, 336) and of the
    raster pack + K5 at (20, 48 000, 14, 112), count by count; then three chunks of
    one stream through ``StreamingLocalizer.process_chunk`` (K1, K2, the pack
    and K4 at B = 1) equal to the plain step in raster, counts and state;
25. the live demos (``haghighatshoarmuir2024_tpu_torch/demos/``) at their
    reference defaults on the card, a synthetic 1750 Hz tone from 0.7 rad at
    10 dB, the designs made on the card (a temporary design cache): the
    Hilbert, SNN, MUSIC and SRP-PHAT demos 8 frames each, the quantized
    Xylo demo 4 (unipolar; K1, K2, the raster pack and K5 on every frame,
    no other hand kernel anywhere in the phase's demos).  MUSIC's reference
    default of 100 active bins must raise ``ValueError`` as JAX's does, and
    the demo runs at the 34 the band allows.  Each demo: the folded error
    within its JAX test's threshold (the Xylo demo, whose test asks only for
    a finite DoA, within one grid step of what JAX's ``run_demo()`` prints),
    ms a frame (median after the first, host clock, synchronized) and the
    real-time factor against the 250 ms frame, the design seconds, the
    ``StageTimer`` report of its loop (source, compute, visualize); its
    first two frames through the port's CPU path on the card's design give
    the card's DoAs (a mismatch passes only at a near tie of the CPU score,
    relative top-two gap below 1e-5, and is printed; none for Xylo); the
    Xylo demo's counts of frame 0 equal the plain path's, and a silent frame
    gives NaN and launches nothing.  A 16-bit 7-channel wav of the Xylo
    demo's frames goes through ``FileAudioSource`` into the Xylo and SRP
    demos, their DoAs equal to the CPU path's on the decoded frames.
    ``utils.profiling.device_trace`` around the flagship
    ``forward_batch(matched)`` must record K1, K2, the pack pass and K3 (a
    trace with no kernel event fails: the profiler's CUPTI tracing is
    missing), their traced durations printed beside phases 3-4's CUDA
    events; ``benchmark_fn`` on the same call (20 iterations) beside phase
    23's total; ``ops.chunked_vmap`` on the card (449 rows, chunks of 64)
    equal to ``torch.func.vmap`` of the whole input.

The kernels line (one JSON object with one entry per kernel, each with its
bound) comes third from last, then the card's name and power limit, then the
last line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

SEED = 0
# doa-ok-frac @5 deg (matched) of the JAX package on the unipolar flagship
# and bench.py's 96 frames: 96 of 96, measured on the CPU (float32; design
# and calibration with use_cache=False).  The card's design and JAX's differ
# in float rounding, so the gate allows one frame less.
JAX_UNIPOLAR_OK = 96
# blocking single-stream and single-frame calls timed per latency reading;
# they are host-bound and spread by about a millisecond
LATENCY_SAMPLES = 10
CHAIN_STAGE = 512  # csrc/lif.cu's STAGE: the steps of slots K3/K4's chain stages at a time


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(torch, fn, reps: int) -> float:
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


def timed_once(torch, fn):
    """``fn()`` and the device milliseconds of that one call, by CUDA
    events: for the LIF kernels' plain versions, seconds a call at the
    flagship, whose check against the kernel is also their timing."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lap(t0: float, done: str) -> None:
    """Where the script's time goes: seconds since its start, after ``done``."""
    print(f"[clock] {time.perf_counter() - t0:.1f} s: {done}", flush=True)


def mismatches(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to("cpu").long() != b.to("cpu").long()).sum())


def widest_distance(sk, W: int = 0) -> int:
    """The largest suppression distance whose halo fits the suppression
    kernels' shared memory: K1's with the plateau bound ``W``, K2/K7's with
    ``W = 0``.  The first design took 125 (K2/K7); no later one may take less."""
    def fits(d):
        return sk.library().hm_rzcc_smem_bytes(sk.TB, sk._margin(d - 1, W)) <= sk.SMEM_MAX

    d = 2
    while fits(d + 1):
        d += 1
    return d


def must_raise_too_wide(fn, label: str):
    try:
        fn()
    except ValueError:
        return
    fail(f"{label}: a window too wide for shared memory did not raise ValueError")


def raw_launch_ms(torch, fn, *args, reps: int = 50) -> float:
    """Device milliseconds of one of the library's C launch functions on
    tensors allocated beforehand: a kernel without its wrapper's host work
    (checks, allocations, a device context), which for K1, K2 and K7 is of
    the order of the launch itself and can set the wrapper's ``ms``."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream):
            fail(f"{fn.__name__} refused its launch")

    return timed_ms(torch, launch, reps)


# ------------------------------------------------------------------ phase 3
def check_suppress(torch, sk, peaks, dev, flagship_cs):
    rng = np.random.default_rng(SEED + 11)
    n_cases = 0

    def wrapper_case(cs_rt: np.ndarray, d, W, label):
        nonlocal n_cases
        cs_tm = torch.as_tensor(np.ascontiguousarray(cs_rt.T), device=dev)
        kp, kn = sk.rzcc_encode_bipolar_tm(cs_tm, d, W)
        rp, rn = sk.rzcc_encode_bipolar_tm_plain(cs_tm, d, W)
        torch.cuda.synchronize()
        bad = mismatches(kp, rp) + mismatches(kn, rn)
        if bad:
            fail(f"K1/K2 {label} d={d} W={W}: {bad} mask elements differ from the plain version")
        n_cases += 1

    for trial, (rows, T) in enumerate([(6, 500), (3, 257), (9, 2050), (40, 3001)]):
        cs = np.cumsum(rng.standard_normal((rows, T)).astype(np.float32), axis=-1)
        if trial == 1:  # exact plateaus: the bounded plateau-midpoint logic
            cs[:, 40:44] = cs[:, 40:41]
            cs[:, 100:103] = cs[:, 100:101]
        for d, W in ((3, 6), (7, 14), (12, 24)):
            wrapper_case(cs, d, W, f"random {rows}x{T}")
    # coarsely quantized walks: plateaus everywhere, some longer than W, many
    # across tile boundaries
    steps = np.round(np.cumsum(rng.standard_normal((7, 2000)), axis=-1) * 2) / 2
    for d, W in ((3, 6), (12, 24), (24, 48)):
        wrapper_case(steps.astype(np.float32), d, W, "quantized walk")
    # wide windows: the 3-band multiband config's (24, 48) and (80, 24)
    t = np.arange(4000, dtype=np.float32)
    drift = np.cumsum(np.sin(2 * np.pi * t / 900.0)[None, :]
                      + 0.3 * rng.standard_normal((3, 4000)).astype(np.float32), axis=-1)
    wide = np.cumsum(rng.standard_normal((6, 6000)).astype(np.float32), axis=-1)
    for d, W in ((24, 48), (80, 24)):
        wrapper_case(drift, d, W, "slow drift")
        wrapper_case(wide, d, W, "random 6x6000")
    # ragged: T not a multiple of anything, rows not a multiple of 32
    wrapper_case(np.cumsum(rng.standard_normal((9, 203)).astype(np.float32), axis=-1), 5, 10, "ragged")
    wrapper_case(np.cumsum(rng.standard_normal((33, 1)).astype(np.float32), axis=-1), 12, 24, "T=1")

    # the word layout's edges: T and tiles that end mid-word, rows inside the
    # four-rows-a-word path but not a multiple of the block (36) and outside it
    # (37), a plateau longer than a word, T shorter than a word
    for rows, T in ((36, sk.TB + 13), (37, 2 * sk.TB + 45), (4, 33)):
        cs = np.cumsum(rng.standard_normal((rows, T)).astype(np.float32), axis=-1)
        cs[:, 3:12] = cs[:, 3:4]
        if T > 100:
            cs[0, 20:61] = cs[0, 20]
        for d, W in ((12, 24), (40, 24), (12, 60)):
            wrapper_case(cs, d, W, f"word edges {rows}x{T}")
    # the widest window K1's shared memory takes (W = 24), and the first past it
    d_k1 = widest_distance(sk, 24)
    wrapper_case(wide, d_k1, 24, "widest window")
    wide_tm = torch.as_tensor(np.ascontiguousarray(wide.T), device=dev)
    must_raise_too_wide(lambda: sk.rzcc_encode_bipolar_tm(wide_tm, d_k1 + 1, 24), f"K1 d={d_k1 + 1}")

    # K2 fixed point from given candidates: exact ties and dense chains
    def k2_case(h_rt: np.ndarray, cand_rt: np.ndarray, d, label, odd=False):
        nonlocal n_cases
        w = int(np.ceil(d)) - 1
        h_tm = torch.as_tensor(np.ascontiguousarray(h_rt.T), device=dev)
        act = torch.as_tensor(np.ascontiguousarray(cand_rt.T), device=dev)
        if odd:  # masks at an odd byte offset: one byte a row, not four rows a word
            act = odd_offset(torch, act)
        none = torch.zeros_like(act)
        kept_p, kept_n = torch.zeros_like(act), torch.zeros_like(act)
        ap, an, rounds = act, none, 0
        while True:
            ap, an, flags = sk.rzcc_k2(h_tm, ap, an, kept_p, kept_n, w)
            rounds += 1
            if not bool(flags.any()):
                break
        ref = peaks.select_by_distance(act.T, h_tm.T, d).T
        bad = mismatches(kept_p, ref) + int(kept_n.any())
        if bad:
            fail(f"K2 {label} d={d}: {bad} elements differ from select_by_distance")
        n_cases += 1
        return rounds

    h = np.zeros((1, 64), np.float32)
    cand = np.zeros((1, 64), bool)
    h[0, [10, 15, 40, 45, 50]] = 1.0
    cand[0, [10, 15, 40, 45, 50]] = True
    for d in (6, 11, 40):
        k2_case(h, cand, d, "exact ties")
    dense = rng.standard_normal((3, 257)).astype(np.float32)
    max_rounds = max(k2_case(dense, np.ones_like(dense, bool), d, "dense chains") for d in (2, 5, 11))
    # long chains across many 256-sample tiles: the halo must carry every round
    dense = rng.standard_normal((5, 3000)).astype(np.float32)
    max_rounds = max([max_rounds] + [k2_case(dense, np.ones_like(dense, bool), d, "dense chains")
                                     for d in (11, 40)])
    # candidates at t = 0 and t = T - 1, T not a multiple of the word, rows
    # not of the block; then all-candidate rows beside empty rows in one warp
    edge_h = rng.standard_normal((37, 2 * sk.TB + 13)).astype(np.float32)
    edge_c = rng.random(edge_h.shape) < 0.05
    edge_c[:, [0, -1]] = True
    for d in (5, 12, 33, 65):
        k2_case(edge_h, edge_c, d, "candidates at both ends")
    k2_case(edge_h, edge_c, 12, "candidates at both ends, odd byte offset", odd=True)
    mixed_h = rng.standard_normal((36, sk.TB + 200)).astype(np.float32)
    mixed_c = np.ones_like(mixed_h, bool)
    mixed_c[1::2] = False
    for d in (11, 40):
        max_rounds = max(max_rounds, k2_case(mixed_h, mixed_c, d, "dense rows beside empty rows"))
    # the widest window K2's shared memory takes, and the first past it
    d_k2 = widest_distance(sk)
    if d_k2 < 125:
        fail(f"K2/K7 take distance <= {d_k2}: narrower than the first design's 125")
    k2_case(edge_h, edge_c, d_k2, "widest window")
    k2_args = [torch.zeros((8, 4), dtype=torch.bool, device=dev) for _ in range(4)]
    must_raise_too_wide(lambda: sk.rzcc_k2(torch.zeros((8, 4), device=dev), *k2_args, d_k2), f"K2 d={d_k2 + 1}")

    # the flagship cs: the whole wrapper, then K1 and one K2 launch alone
    T, R = flagship_cs.shape
    w, W = sk._windows(12, 24)
    kp, kn = sk.rzcc_encode_bipolar_tm(flagship_cs, 12, 24)
    rp, rn = sk.rzcc_encode_bipolar_tm_plain(flagship_cs, 12, 24)
    bad = mismatches(kp, rp) + mismatches(kn, rn)
    k1 = sk.rzcc_k1(flagship_cs, w, W)
    k1_ref = sk._k1_plain(flagship_cs, w, W)
    k1_bad = sum(mismatches(a, b) for a, b in zip(k1, k1_ref))
    kept_p, kept_n = k1[2].clone(), k1[3].clone()
    ap, an, _ = sk.rzcc_k2(flagship_cs, k1[0], k1[1], kept_p, kept_n, w)
    k2_ref = sk._k2_plain(flagship_cs, *k1_ref, w)
    k2_bad = sum(mismatches(a, b) for a, b in zip((ap, an, kept_p, kept_n), k2_ref))
    if bad or k1_bad or k2_bad:
        fail(f"flagship cs: wrapper {bad}, K1 {k1_bad}, K2 {k2_bad} elements differ")
    n_cases += 1
    spikes = int(kp.sum()) + int(kn.sum())
    print(f"[K1/K2] {n_cases} cases bit-exact vs plain (dense chains up to {max_rounds} K2 rounds; tiles of "
          f"{sk.TB} samples; widest distance K1 {d_k1} at W = 24, K2 {d_k2}, one more raises); "
          f"flagship cs {T}x{R}: {spikes} spikes, K1 and one K2 launch bit-exact", flush=True)

    ms_k1 = timed_ms(torch, lambda: sk.rzcc_k1(flagship_cs, w, W), 20)
    ms_k1_plain = timed_ms(torch, lambda: sk._k1_plain(flagship_cs, w, W), 5)
    ms_k2 = timed_ms(torch, lambda: sk.rzcc_k2(flagship_cs, k1[0], k1[1], k1[2], k1[3], w), 20)
    ms_k2_plain = timed_ms(torch, lambda: sk._k2_plain(flagship_cs, *k1_ref, w), 5)
    ms_rzcc = timed_ms(torch, lambda: sk.rzcc_encode_bipolar_tm(flagship_cs, 12, 24), 20)
    ms_rzcc_plain = timed_ms(torch, lambda: sk.rzcc_encode_bipolar_tm_plain(flagship_cs, 12, 24), 5)
    lib, ptr = sk.library(), (lambda t: t.data_ptr())
    outs = [torch.empty_like(m) for m in k1]
    flags = torch.empty((-(-T // sk.TB), -(-R // lib.hm_rzcc_rows_per_block())), dtype=torch.int32, device=dev)
    raw_k1 = raw_launch_ms(torch, lib.hm_rzcc_k1, ptr(flagship_cs), *map(ptr, outs), T, R, w, W,
                           sk._margin(w, W), sk.TB)
    # K1's masks in, as the flagship's one K2 launch; the kept bits it sets again are the same bits
    raw_k2 = raw_launch_ms(torch, lib.hm_rzcc_k2, ptr(flagship_cs), ptr(k1[0]), ptr(k1[1]), ptr(outs[0]),
                           ptr(outs[1]), ptr(k1[2]), ptr(k1[3]), ptr(flags), T, R, w, sk._margin(w), sk.TB)
    return {
        "k1": dict(max_abs_err=float(k1_bad), ms=ms_k1, plain_ms=ms_k1_plain, raw_ms=raw_k1),
        "k2": dict(max_abs_err=float(k2_bad), ms=ms_k2, plain_ms=ms_k2_plain, raw_ms=raw_k2),
        "rzcc_ms": ms_rzcc, "rzcc_plain_ms": ms_rzcc_plain,
    }


# ------------------------------------------------------------------ phase 4
def make_config(XyloConfig, seed, C=6, N=20, w_scale=20, rec=0, rows=None):
    """A random config of ``rows`` input channels (2C by default: both
    polarities of C channels)."""
    r = np.random.default_rng(seed)
    return XyloConfig(
        w_in=r.integers(-w_scale, w_scale + 1, size=(rows or 2 * C, N)).astype(np.int32),
        w_rec=np.full((N, N), rec, np.int32),
        w_out=np.ones((N, 1), np.int32),
        dash_syn=r.integers(1, 7, size=N).astype(np.int32),
        dash_mem=r.integers(1, 7, size=N).astype(np.int32),
        dash_syn_out=np.ones(1, np.int32), dash_mem_out=np.ones(1, np.int32),
        threshold=r.integers(30, 200, size=N).astype(np.int32),
        threshold_out=np.ones(1, np.int32), dt=1e-3, weight_scale=1.0,
    )


def with_rec(config, rec):
    """``config`` with the uniform recurrence ``w_rec = rec·ones``."""
    return dataclasses.replace(config, w_rec=np.full_like(np.asarray(config.w_rec), rec))


def masks(torch, dev, seed, T, B, C, p):
    r = np.random.default_rng(seed + 1000)
    kp = torch.as_tensor(r.random((T, B, C)) < p, device=dev)
    kn = torch.as_tensor(r.random((T, B, C)) < p, device=dev)
    return kp, kn


def check_pack(torch, lk, kp, kn, label):
    """The pack kernel against its plain version on the same masks; returns
    the number of differing elements of words, slots and overflow bits."""
    got = lk.pack_bipolar_masks(kp, kn)
    ref = lk.pack_bipolar_masks_plain(kp, kn)
    torch.cuda.synchronize()
    bad = sum(mismatches(a, b) for a, b in zip(got, ref))
    if bad:
        fail(f"pack {label}: {bad} mask words, slots or most-set-bit counts differ from the plain version")
    return bad


def odd_offset(torch, x):
    """``x`` copied into a contiguous view that starts at an odd byte offset
    of its storage."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def six_bits_every_chunk(kp, kn):
    """The masks with exactly six set bits (kp on channels 0-5) at the first
    step of every CHAIN_STAGE steps: the chain then reads six slots a step
    in every chunk."""
    kp, kn = kp.clone(), kn.clone()
    kp[::CHAIN_STAGE] = 0
    kn[::CHAIN_STAGE] = 0
    kp[::CHAIN_STAGE, :, :6] = 1
    return kp, kn


def lif_cases(torch, make, rand, flagship_config, flagship_masks):
    """K3/K4's mask families: (label, config, (kp, kn), must_clip)."""
    kp, kn = flagship_masks
    N = np.asarray(flagship_config.w_in).shape[1]
    sat = make(11, w_scale=5000)
    sat.threshold[:] = 25_000
    to = lambda m, dtype, v: (m.to(dtype) * v).contiguous()  # noqa: E731
    rkp, rkn = rand(8, 700, 3, 14, 0.2)
    return [
        ("random", make(0), rand(0, 50, 3, 6, 0.15), False),
        ("random, N=200", make(1, N=200), rand(1, 777, 5, 6, 0.2), False),
        ("ragged T=12001", make(2, C=14, N=N, w_scale=49), rand(2, 12001, 2, 14, 0.05), False),
        ("T=1", make(4, C=14, N=N, w_scale=400), rand(4, 1, 3, 14, 0.3), False),
        ("T=7", make(5, C=14, N=N, w_scale=49), rand(5, 7, 3, 14, 0.3), False),
        ("T=9", make(6, C=14, N=N, w_scale=49), rand(6, 9, 3, 14, 0.3), False),
        ("T=513", make(16, C=14, N=N, w_scale=49), rand(16, 513, 3, 14, 0.1), False),
        ("saturating", sat, rand(11, 300, 3, 6, 0.9), True),
        ("flagship", flagship_config, flagship_masks, False),
        ("flagship, six set bits a chunk", flagship_config, six_bits_every_chunk(kp, kn), False),
        ("dense, flagship width", make(7, C=14, N=N, w_scale=4), rand(7, 2000, 4, 14, 0.9), False),
        ("C=32", make(9, C=32, N=300, w_scale=12), rand(9, 1500, 3, 32, 0.05), False),
        ("C=32 dense", make(10, C=32, N=100, w_scale=2), rand(10, 300, 2, 32, 0.8), False),
        ("C=1", make(12, C=1, N=64, w_scale=60), rand(12, 1500, 3, 1, 0.3), False),
        ("B=1", flagship_config, (kp[:, :1].contiguous(), kn[:, :1].contiguous()), False),
        ("uint8 and int8 values", make(13, C=14, N=200, w_scale=49),
         (to(rkp, torch.uint8, 7), to(rkn, torch.uint8, 200)), False),
        ("int8 values, odd byte offset", make(14, C=14, N=200, w_scale=49),
         (odd_offset(torch, to(rkp, torch.int8, -3)), odd_offset(torch, to(rkn, torch.int8, 5))), False),
        ("rec_coef=-1", make(3, N=200, rec=-1), rand(3, 1500, 4, 6, 0.2), False),
        ("rec_coef=-1, C=32", make(15, C=32, N=150, rec=-1, w_scale=12), rand(15, 700, 2, 32, 0.05), False),
        # a row of 1000 neurons in one block: its stages take more than 48 KB
        ("rec_coef=-1, N=1000", make(17, C=14, N=1000, rec=-1, w_scale=49), rand(17, 1500, 3, 14, 0.05), False),
        ("rec_coef=-1, flagship width", with_rec(flagship_config, -1), flagship_masks, False),
        # 128-bit mask words: C = 33, the three-band model's 42, 63 and 64 (bit 127 and slot bytes up to
        # 128), dense at 64 (every chunk on the out-of-line word loop), the uniform recurrence at 42
        ("C=33", make(18, C=33, N=300, w_scale=12), rand(18, 1500, 3, 33, 0.05), False),
        ("C=42", make(19, C=42, N=300, w_scale=12), rand(19, 1500, 3, 42, 0.05), False),
        ("C=63", make(20, C=63, N=200, w_scale=8), rand(20, 1500, 3, 63, 0.05), False),
        ("C=64", make(21, C=64, N=200, w_scale=8), rand(21, 1500, 3, 64, 0.05), False),
        ("C=64 dense", make(22, C=64, N=100, w_scale=2), rand(22, 300, 2, 64, 0.8), False),
        ("rec_coef=-1, C=42", make(23, C=42, N=150, rec=-1, w_scale=12), rand(23, 700, 2, 42, 0.05), False),
    ]


def lk_max_channels(lk) -> int:
    """The widest channels a polarity K3/K4 take; 64 since the 128-bit mask word."""
    c = lk.library().hm_lif_max_channels()
    if c < 64:
        fail(f"K3/K4 take {c} channels a polarity; the three-band model needs 42 and the port promises 64")
    return c


def check_lif(torch, lk, XyloConfig, dev, flagship_config, flagship_masks):
    make = functools.partial(make_config, XyloConfig)
    rand = functools.partial(masks, torch, dev)
    cases = lif_cases(torch, make, rand, flagship_config, flagship_masks)
    pack_bad, plain_ms = 0, {}
    for label, cfg, (kp, kn), must_clip in cases:
        if must_clip and lk._no_saturation_possible(cfg, 1, 0):
            fail(f"K3 {label}: the case was meant to exercise the clip path")
        pack_bad += check_pack(torch, lk, kp, kn, label)
        got = lk.lif_count_rates_bipolar(cfg, kp, kn, spike_bound=1)
        ref, plain_ms[label] = timed_once(torch, lambda: lk.lif_count_plain(cfg, kp, kn))
        bad = mismatches(got, ref)
        if bad:
            fail(f"K3 {label}: {bad} counts differ from the plain simulator")
        if int(ref.sum()) == 0:
            fail(f"K3 {label}: no neuron fired, the case checks nothing")
    # one channel past the widest mask word: the wrappers raise, no other route
    too_wide = masks(torch, dev, 65, 40, 2, lk_max_channels(lk) + 1, 0.1)
    must_raise_too_wide(lambda: lk.lif_count_rates_bipolar(make(65, C=65, N=20), *too_wide), "K3 C=65")
    must_raise_too_wide(lambda: lk.pack_bipolar_masks(*too_wide), "pack C=65")
    print(f"[K3] {len(cases)} cases bit-exact vs plain sim_hidden, the pack kernel bit-exact vs its plain "
          "version on each (incl. saturating clip path, ragged T = 1, 7, 9, 513, 12001, flagship config and "
          "masks, the flagship masks with six set bits a chunk, dense masks, C = 32 and 1, B = 1, uint8/int8 "
          "values, an odd byte offset, rec_coef = -1; 128-bit words at C = 33, 42, 63, 64, dense at 64, "
          f"rec_coef = -1 at 42); C = {lk_max_channels(lk) + 1} raises", flush=True)
    kp, kn = flagship_masks
    T, B, _ = kp.shape
    # what the chain meets: steps (of B*T) by set bits, and chunks of
    # CHAIN_STAGE steps by the most set bits a step of theirs has (at most 4:
    # four slots a step; 5-6: six; more: the mask words)
    bits = (torch.cat([kp & ~kn, kn], dim=-1) != 0).sum(dim=-1)  # (T, B)
    most = torch.zeros((-(-T // CHAIN_STAGE) * CHAIN_STAGE, B), dtype=bits.dtype, device=dev)
    most[:T] = bits
    most = most.reshape(-1, CHAIN_STAGE, B).amax(dim=1)
    print(f"[K3] flagship input: steps by set bits {torch.bincount(bits.flatten()).tolist()}; chunks of "
          f"{CHAIN_STAGE} steps {most.numel()}, on six slots {int(((most > 4) & (most <= 6)).sum())}, "
          f"on the mask words {int((most > 6).sum())}", flush=True)
    # ms converts the config on every call, this script's yardstick for K3-K6
    # from its first version; params_ms takes the LIF integers uploaded once,
    # as Demo and the streaming runtime pass them; six_ms is params_ms on the
    # flagship masks with six set bits a chunk (six slots read in every chunk)
    params = lk.lif_params(flagship_config, dev, spike_bound=1)
    ms = timed_ms(torch, lambda: lk.lif_count_rates_bipolar(flagship_config, kp, kn, spike_bound=1), 20)
    params_ms = timed_ms(torch, lambda: lk.lif_count_rates_bipolar(params, kp, kn), 20)
    kp6, kn6 = six_bits_every_chunk(kp, kn)
    six_ms = timed_ms(torch, lambda: lk.lif_count_rates_bipolar(params, kp6, kn6), 20)
    pack = dict(max_abs_err=float(pack_bad), ms=timed_ms(torch, lambda: lk.pack_bipolar_masks(kp, kn), 20),
                plain_ms=timed_ms(torch, lambda: lk.pack_bipolar_masks_plain(kp, kn), 3))
    return dict(max_abs_err=0.0, ms=ms, params_ms=params_ms, six_ms=six_ms, plain_ms=plain_ms["flagship"]), pack


# ------------------------------------------------------------------ phase 6
def check_lif_stateful(torch, lk, XyloConfig, dev, flagship_config, flagship_masks):
    make = functools.partial(make_config, XyloConfig)
    rand = functools.partial(masks, torch, dev)
    n_cases, worst, plain_ms = 0, 0, {}

    def zeros(B, N):
        return tuple(torch.zeros((B, N), dtype=torch.int32, device=dev) for _ in range(3))

    def case(label, cfg, kp, kn, state0, need_spikes=True):
        nonlocal n_cases, worst
        check_pack(torch, lk, kp, kn, label)
        got = lk.lif_count_stateful_bipolar(cfg, kp, kn, *state0, spike_bound=1)
        ref, plain_ms[label] = timed_once(torch, lambda: lk.lif_count_stateful_bipolar_plain(cfg, kp, kn, *state0))
        bad = sum(mismatches(a, b) for a, b in zip(got, ref))
        if bad:
            fail(f"K4 {label}: {bad} elements of counts/isyn/vmem/spk differ from the plain simulator")
        if need_spikes and int(ref[0].sum()) == 0:
            fail(f"K4 {label}: no neuron fired, the case checks nothing")
        worst = max([worst] + [int((a.long() - b.long()).abs().max()) for a, b in zip(got, ref)])
        n_cases += 1
        return got

    kp, kn = flagship_masks
    T, B, _ = kp.shape
    N = np.asarray(flagship_config.w_in).shape[1]
    first = case("flagship chunk 1", flagship_config, kp, kn, zeros(B, N))
    # a second chunk (the time-reversed masks) from the state the first left
    kp2, kn2 = kp.flip(0).contiguous(), kn.flip(0).contiguous()
    second = case("flagship chunk 2, carried", flagship_config, kp2, kn2, first[1:])
    whole = lk.lif_count_stateful_bipolar(flagship_config, torch.cat([kp, kp2]), torch.cat([kn, kn2]),
                                          *zeros(B, N), spike_bound=1)
    bad = mismatches(whole[0], first[0] + second[0]) + sum(
        mismatches(a, b) for a, b in zip(whole[1:], second[1:]))
    if bad:
        fail(f"K4: two chunks carried differ from one pass of {2 * T} steps in {bad} elements")
    # mid-stream states come from the plain dynamics on earlier masks
    cfg = make(5, N=200)
    mid = lk.lif_count_stateful_bipolar_plain(cfg, *rand(6, 300, 5, 6, 0.2), None, None, None)
    case("ragged T=777, mid-stream state", cfg, *rand(5, 777, 5, 6, 0.2), mid[1:])
    sat = make(11, w_scale=5000)
    sat.threshold[:] = 25_000
    if lk._no_saturation_possible(sat, 1, 0):
        fail("K4 saturating: the case was meant to exercise the clip path")
    mid = lk.lif_count_stateful_bipolar_plain(sat, *rand(12, 200, 3, 6, 0.9), None, None, None)
    case("saturating clip path", sat, *rand(11, 301, 3, 6, 0.9), mid[1:])
    rec = with_rec(flagship_config, -1)
    head = case("rec_coef=-1, flagship width", rec, kp[:3000].contiguous(), kn[:3000].contiguous(), zeros(B, N))
    case("rec_coef=-1, carried", rec, kp[3000:6001].contiguous(), kn[3000:6001].contiguous(), head[1:])
    # chunks whose lengths are not multiples of the chain's group of 8 steps,
    # carried, against one pass over the same 4019 steps
    state, total, lo = zeros(B, N), torch.zeros((B, N), dtype=torch.int32, device=dev), 0
    for Tc in (1001, 1, 7, 9, 3001):
        out = case(f"carried chunk of {Tc}", flagship_config, kp[lo:lo + Tc].contiguous(),
                   kn[lo:lo + Tc].contiguous(), state, need_spikes=False)
        total, state, lo = total + out[0], out[1:], lo + Tc
    whole = lk.lif_count_stateful_bipolar(flagship_config, kp[:lo].contiguous(), kn[:lo].contiguous(),
                                          *zeros(B, N), spike_bound=1)
    bad = mismatches(whole[0], total) + sum(mismatches(a, b) for a, b in zip(whole[1:], state))
    if bad:
        fail(f"K4: chunks of 1001, 1, 7, 9, 3001 carried differ from one pass of {lo} steps in {bad} elements")
    # the mask families of phase 4 from mid-stream states of the plain dynamics
    for label, cfg, (mkp, mkn), _ in lif_cases(torch, make, rand, flagship_config, flagship_masks):
        if label in ("flagship", "random", "rec_coef=-1, flagship width", "saturating", "ragged T=12001"):
            continue  # above
        mid = lk.lif_count_stateful_bipolar_plain(cfg, mkp[:7].flip(0).contiguous(), mkn[:7].flip(0).contiguous(),
                                                  None, None, None)
        case(label + ", mid-stream state", cfg, mkp, mkn, mid[1:], need_spikes=label != "T=1")
    print(f"[K4] {n_cases} cases bit-exact vs plain sim_hidden on counts and final isyn/vmem/spk, the pack "
          f"kernel on each (flagship B={B} Tc={T}, two chunks carried == one pass of {2 * T}, chunks of 1001, "
          "1, 7, 9, 3001 carried == one pass, ragged T, dense masks, C = 32 and 1, B = 1, uint8/int8 values, "
          "an odd byte offset, clip path, rec_coef = -1; C = 33, 42, 63, 64, dense at 64, rec_coef = -1 at 42)",
          flush=True)
    params = lk.lif_params(flagship_config, dev, spike_bound=1)  # as the streaming runtime passes them
    ms = timed_ms(torch, lambda: lk.lif_count_stateful_bipolar(flagship_config, kp2, kn2, *first[1:]), 20)
    params_ms = timed_ms(torch, lambda: lk.lif_count_stateful_bipolar(params, kp2, kn2, *first[1:]), 20)
    return dict(max_abs_err=float(worst), ms=ms, params_ms=params_ms, plain_ms=plain_ms["flagship chunk 2, carried"])


# ------------------------------------------------------------------ phase 7
def ok_frac(est, doas, tol_deg):
    err = np.abs(np.arcsin(np.abs(np.sin(np.asarray(est) - doas))))
    return float(np.mean(np.rad2deg(err) < tol_deg))


def plain_bipolar_rows(torch, lk, cfg, kp, kn, state=None):
    """The plain K3/K4 (``lif_count_stateful_bipolar_plain``) as many batch
    rows at a time as keep its float64 input currents (T, rows, N) within
    4 GiB, the rows being independent: every row at once at the flagship,
    32 at the three-band model's N = 1347, where one pass over 96 rows
    would hold 19 GB."""
    T, N = kp.shape[0], np.asarray(cfg.w_in).shape[1]
    rows = max(1, (4 << 30) // (8 * max(T, 1) * N))
    outs = []
    for lo in range(0, kp.shape[1], rows):
        s = slice(lo, lo + rows)
        st = (None, None, None) if state is None else tuple(x[s] for x in state)
        outs.append(lk.lif_count_stateful_bipolar_plain(cfg, kp[:, s], kn[:, s], *st))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def plain_step(torch, sk, lk, sl, state, chunks):
    """``StreamingLocalizer._step`` with the plain RZCC and the plain LIF:
    what the kernels' step is held to.  Returns the new state and the int8
    raster ``process_chunk`` returns."""
    B, Tc, _ = chunks.shape
    fir_tail, delay_line, iir_state, int_carry, integrated = sl._encode(state, chunks.transpose(0, 1))
    analysis = torch.cat([state.pending, integrated], dim=0)
    kp, kn = sk.rzcc_encode_bipolar_tm_plain(analysis.reshape(analysis.shape[0], B * sl.C), sl.rw, 2 * sl.rw)
    kp = kp[sl.guard:sl.guard + Tc].reshape(Tc, B, sl.C)
    kn = kn[sl.guard:sl.guard + Tc].reshape(Tc, B, sl.C)
    cfg = sl.demo.xylo_config
    if sl.bipolar:
        counts, isyn, vmem, spk = plain_bipolar_rows(torch, lk, cfg, kp, kn, (state.isyn, state.vmem, state.spk))
        spikes = torch.cat([kp & ~kn, kn], dim=-1).to(torch.int8)
    else:
        spikes = kp.to(torch.int8)
        counts, isyn, vmem, spk = lk.lif_count_stateful_plain(cfg, spikes, state.isyn, state.vmem, state.spk)
    new = dataclasses.replace(
        state, fir_tail=fir_tail, delay_line=delay_line, iir_state=iir_state, int_carry=int_carry,
        pending=analysis[Tc:], isyn=isyn, vmem=vmem, spk=spk, counts=state.counts + counts,
        steps=state.steps + Tc)
    return new, spikes


def check_streaming(torch, sk, lk, _build, StreamingLocalizer, demo, frames, doas, n_chunks=4):
    sl = StreamingLocalizer(demo)
    B, Tc, _ = frames.shape
    sl.process_chunk(sl.init_state(B), frames, return_spikes=False)  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    state, spikes = sl.init_state(B), []
    for _ in range(n_chunks):  # the same chunk repeated, as serving_throughput.py does
        state, sp = sl.process_chunk(state, frames)
        spikes.append(sp)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    for name in ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k4"):
        if launches.get(name, 0) < 1:
            fail(f"the streaming run never launched {name} (launch counts {launches})")
    pstate = sl.init_state(B)
    for k in range(n_chunks):
        pstate, psp = plain_step(torch, sk, lk, sl, pstate, frames)
        bad = mismatches(spikes[k], psp)
        if bad:
            fail(f"streaming chunk {k}: {bad} spikes differ from the plain RZCC")
    bad = sum(mismatches(getattr(state, f), getattr(pstate, f)) for f in ("counts", "isyn", "vmem", "spk"))
    if bad:
        fail(f"streaming: {bad} elements of the LIF counts/state differ from the plain path")
    est = sl.estimate_doa(state, "matched").cpu().numpy()
    ok = ok_frac(est, doas, 5.0)
    print(f"[stream] B={B} {n_chunks} x Tc={Tc}: launches {launches}; spikes and counts identical to the "
          f"plain RZCC + plain LIF; doa-ok-frac {ok:.2f} @5deg (matched)", flush=True)
    if ok < 1.0:
        fail(f"streaming accuracy gate failed: doa-ok-frac {ok:.2f} @5deg")

    n_rep = 20
    st = sl.process_chunk(sl.init_state(B), frames, return_spikes=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_rep):
        st = sl.process_chunk(st, frames, return_spikes=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / n_rep * 1e3
    s1 = sl.process_chunk(sl.init_state(), frames[0], return_spikes=False)
    torch.cuda.synchronize()
    lat = []
    for _ in range(LATENCY_SAMPLES):
        t1 = time.perf_counter()
        s1 = sl.process_chunk(s1, frames[0], return_spikes=False)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    return launches, dict(step_ms=step_ms, latency_ms=float(np.median(lat)), latency_max_ms=max(lat))


# ------------------------------------------------------------------ phase 8
def check_serving(torch, _build, StreamingLocalizer, server, resample, mulaw, demo, frames, n_chunks=4,
                  wires=(("f32", 1), ("u4", 4)), method=None):
    """8 TCP clients through the daemon; each answer must equal the DoA of
    the direct streaming step at the same batch width on the same chunks
    (by the server's estimator, ``method`` where given).  The serve-step
    times leave out the first round of chunks: a new serving thread pays
    one-off CUDA library set-up on its first step."""
    os.environ["HM2024_SERVE_TIMING"] = "1"
    B, Tc, M = frames.shape
    sids = list(range(0, B, B // 8))[:8]
    audio = frames.cpu().numpy()
    out = {}
    for wire, up in wires:
        if wire == "f32":
            sent = {s: [audio[s]] * n_chunks for s in sids}
        else:
            sent = {}
            for s in sids:
                enc = server.WireEncoder(wire, wire_upsample=up)
                x = audio[s] / np.abs(audio[s]).max() * 0.98
                sent[s] = [enc.encode(x) for _ in range(n_chunks)]
        with server.LocalizationServer(demo, max_streams=B, chunk_sec=Tc / demo.fs,
                                       wire_dtype=wire, wire_upsample=up, method=method) as srv:
            srv.start()
            clients = {s: server.StreamClient(srv.port, s) for s in sids}
            _build.launch_counts.clear()
            answers = {s: [] for s in sids}
            for k in range(n_chunks):
                for s, c in clients.items():
                    c.send(sent[s][k])
                for s, c in clients.items():
                    rid, doa = c.recv_doa(timeout=120.0)
                    if rid != s:
                        fail(f"serving {wire}: stream {s} got an answer for stream {rid}")
                    answers[s].append(doa)
                if k == 0:
                    time.sleep(0.2)  # the server books a step's times just after it answers
                    first = dict(srv.stage_times)
            time.sleep(0.2)
            launches = dict(_build.launch_counts)
            stage = {k: v - first[k] for k, v in srv.stage_times.items()}
            for c in clients.values():
                c.close()
        for name in ("rzcc_k1", "lif_pack", "lif_k4"):
            if launches.get(name, 0) < 1:
                fail(f"serving {wire}: the daemon never launched {name} (launch counts {launches})")

        # the direct streaming step on the same chunks, all B lanes advanced
        sl = StreamingLocalizer(demo)
        state = sl.init_state(B)
        carry = torch.zeros((B, resample.TAPS_PER_PHASE - 1, M), device=demo.device)
        hp = resample.phase_table(resample.design_upsample_fir(up), up) if up > 1 else None
        for k in range(n_chunks):
            if wire == "f32":
                x = np.zeros((B, Tc, M), np.float32)
                for s in sids:
                    x[s] = sent[s][k]
                chunks = torch.as_tensor(x, device=demo.device)
            else:
                xw = np.zeros((B, Tc // up, M), np.float32)
                for s in sids:
                    xw[s] = mulaw.mulaw4_decode(mulaw.unpack4(sent[s][k]))
                chunks, carry = resample.upsample_poly_stream(torch.as_tensor(xw, device=demo.device), carry, hp, up)
            state = sl.process_chunk(state, chunks, return_spikes=False)
            direct = sl.estimate_doa(state, srv.method).to(torch.float32).cpu().numpy()
            bad = [s for s in sids if np.float32(answers[s][k]) != direct[s]]
            if bad:
                fail(f"serving {wire}: chunk {k}: streams {bad} answered "
                     f"{[answers[s][k] for s in bad]}, the direct step gives {[float(direct[s]) for s in bad]}")
        steps = max(stage["steps"], 1)
        out[wire] = dict(steps=stage["steps"],
                         **{f"{k}_ms": stage[k] / steps * 1e3 for k in ("wait", "device", "route")})
        print(f"[serve] wire {wire} x{up}, {srv.method}: {len(sids)} clients x {n_chunks} chunks answered, every "
              f"DoA equal to the direct streaming step; launches {launches}", flush=True)
    return out


# ------------------------------------------------------------------ phase 9
def complex_cols(bf):
    m = bf.shape[0] // 2
    return bf[:m].astype(np.float64) + 1j * bf[m:].astype(np.float64)


def check_design(torch, Demo, flagship, demo, frames, doas):
    """The bipolar flagship designed on the card against the bundled design;
    the profiles computed from the bundled design against the bundled
    table."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    designed = Demo(**flagship, use_cache=False)
    torch.cuda.synchronize()
    design_s = time.perf_counter() - t0
    ref, got = complex_cols(demo.bf_mats[0]), complex_cols(designed.bf_mats[0])
    cos = np.abs(np.sum(ref.conj() * got, axis=0)) / (np.linalg.norm(ref, axis=0) * np.linalg.norm(got, axis=0))
    min_cos = float(cos.min())
    print(f"[design] bipolar flagship designed on the card in {design_s:.3f} s; smallest per-column "
          f"|<bundled bf_0, card bf_0>| up to a unit phase = {min_cos:.9f} (1 - {1 - min_cos:.3e}; "
          f"1e-5 target {'met' if min_cos >= 1 - 1e-5 else 'missed'})", flush=True)
    if min_cos < 1 - 1e-4:
        fail(f"the card's bipolar design differs from the bundled one: smallest column cosine {min_cos}")

    calib = Demo(**flagship)  # the bundled design
    t0 = time.perf_counter()
    prof = calib.calibrate_profiles(use_cache=False)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    row_cos = np.sum(prof.astype(np.float64) * demo._profiles.astype(np.float64), axis=1)
    doa, _ = calib.forward_batch(frames, method="matched")
    ok = ok_frac(doa.cpu().numpy(), doas, 5.0)
    print(f"[design] profiles computed on the card from the bundled design in {calib_s:.3f} s: smallest "
          f"row cosine against the bundled table {row_cos.min():.6f}; slice doa-ok-frac {ok:.2f} @5deg "
          "(matched, computed table)", flush=True)
    if ok < 1.0:
        fail(f"matched gate with the computed profiles failed: doa-ok-frac {ok:.2f} @5deg")
    return dict(design_s=design_s, min_cos=min_cos, calib_s=calib_s, min_row_cos=float(row_cos.min()))


# ------------------------------------------------------------------ phase 10
def check_unipolar(torch, sk, lk, _build, Demo, flagship, frames, doas):
    """Design and calibrate the unipolar flagship on the card, then the
    matched batch forward against the plain path and the JAX package's
    accuracy."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    udemo = Demo(**{**flagship, "bipolar_spikes": False}, use_cache=False)
    torch.cuda.synchronize()
    design_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    udemo.calibrate_profiles(use_cache=False)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    cfg = udemo.xylo_config
    print(f"[unipolar] designed in {design_s:.3f} s, calibrated in {calib_s:.3f} s on the card: w_in "
          f"{tuple(cfg.w_in.shape)} in [{cfg.w_in.min()}, {cfg.w_in.max()}], w_rec {np.unique(cfg.w_rec)}, "
          f"dash_syn {np.unique(cfg.dash_syn)}, dash_mem {np.unique(cfg.dash_mem)}, threshold "
          f"{np.unique(cfg.threshold)}; clips proven dead: {lk._no_saturation_possible(cfg, 1, 0)}",
          flush=True)
    udemo.forward_batch(frames, method="matched")  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    doa, rate = udemo.forward_batch(frames, method="matched")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if launches.get("rzcc_k1") != 1 or launches.get("rzcc_k2", 0) < 1 or launches.get("lif_k5") != 1 \
            or launches.get("lif_pack_raster") != 1 or "lif_k3" in launches or "lif_pack" in launches:
        fail(f"the unipolar batch run launched {launches}; expected K1 once, K2, the raster pack and K5 once")
    B, T, _ = frames.shape
    cs = udemo.encode(frames)
    p_kp, _ = sk.rzcc_encode_bipolar_tm_plain(cs.reshape(T, B * cs.shape[-1]), udemo.robust_width,
                                              2 * udemo.robust_width)
    p_counts = lk.lif_count_stateful_plain(cfg, p_kp.reshape(T, B, -1).to(torch.int8))[0]
    p_doa, p_rate = udemo.estimate(p_counts, T, "matched")
    if not torch.equal(doa, p_doa) or not torch.equal(rate, p_rate):
        fail("unipolar DoAs/rates differ from the plain path's")
    est = doa.cpu().numpy()
    n_ok = int(round(ok_frac(est, doas, 5.0) * B))
    print(f"[unipolar] B={B} T={T}: launches {launches}; DoAs identical to the plain path; doa-ok-frac "
          f"{n_ok / B:.4f} @5deg (matched; {n_ok}/{B}; the JAX package: {JAX_UNIPOLAR_OK}/{B})", flush=True)
    if n_ok < JAX_UNIPOLAR_OK - 1:
        fail(f"unipolar accuracy gate failed: {n_ok}/{B} within 5deg, JAX {JAX_UNIPOLAR_OK}/{B}")
    return udemo, dict(design_s=design_s, calib_s=calib_s, launches=launches, ok=n_ok / B)


# ------------------------------------------------------------------ phase 11
def raster(torch, dev, seed, T, B, C, p, lo=1, hi=2):
    """(T, B, C) int8 raster: nonzero with probability p, values in [lo, hi)."""
    r = np.random.default_rng(seed + 2000)
    v = np.where(r.random((T, B, C)) < p, r.integers(lo, hi, size=(T, B, C)), 0)
    return torch.as_tensor(v.astype(np.int8), device=dev)


def with_weights(config, entries):
    """``config`` with the ``w_in`` entries ``{(row, column): value}`` set."""
    w = np.array(config.w_in)
    for at, v in entries.items():
        w[at] = v
    return dataclasses.replace(config, w_in=w)


def check_raster_pack(torch, lk, spikes, label):
    """The raster pack kernel against its plain version; returns the number
    of differing bytes."""
    got, ref = lk.pack_raster(spikes), lk.pack_raster_plain(spikes)
    torch.cuda.synchronize()
    bad = mismatches(got, ref)
    if bad:
        fail(f"raster pack {label}: {bad} bytes differ from the plain version")
    return bad


def raster_cases(torch, lk, make, ras):
    """K5/K6's case families around the new design's edges: (label, config,
    raster, spike_bound, planes K5/K6 must take for the config's weights)."""
    extreme = ras(40, 300, 3, 33, 0.5, -128, 128)
    extreme[0, 0, 0], extreme[0, 0, 1] = -128, 127
    int8_cfg = with_weights(make(41, N=70, w_scale=120, rows=14), {(0, 0): 127, (1, 0): -127, (2, 1): -128})
    cases = [(f"C={C}", make(50 + C, N=70, w_scale=20 if C < 40 else 6, rows=C),
              ras(50 + C, 300, 2, C, 0.3 if C < 40 else 0.1, -5, 6), None, 1) for C in (1, 31, 32, 33, 64, 65)]
    cases += [
        ("bool raster", make(42, N=449, w_scale=49, rows=14), ras(42, 1000, 3, 14, 0.1).bool(), 1, 1),
        ("values -128 and 127, C=33", make(43, N=70, w_scale=127, rows=33), extreme, None, 1),
        ("|w| = 127 and -128: one int8 plane", int8_cfg, ras(44, 300, 3, 14, 0.3, 0, 4), None, 1),
        ("|w| = 128: two byte planes", with_weights(int8_cfg, {(3, 2): 128}), ras(44, 300, 3, 14, 0.3, 0, 4), None, 2),
        ("weights within int16", with_weights(make(45, N=70, w_scale=30_000, rows=14), {(0, 0): 32767, (1, 1): -32768}),
         ras(45, 300, 3, 14, 0.2), None, 2),
        ("weights beyond int16",
         with_weights(make(46, N=70, w_scale=1_000_000, rows=14), {(0, 0): 32768, (1, 1): -8_388_609}),
         ras(46, 300, 3, 14, 0.2), None, 4),
        ("T=15", make(47, N=449, w_scale=49, rows=14), ras(47, 15, 3, 14, 0.3), 1, 1),
        ("T=16", make(48, N=449, w_scale=49, rows=14), ras(48, 16, 3, 14, 0.3), 1, 1),
        ("T=17", make(49, N=449, w_scale=49, rows=14), ras(49, 17, 3, 14, 0.3), 1, 1),
        # a row of 1000 neurons in one block, eight k-tiles: the most shared memory the kernels ask for
        ("rec_coef=-1, N=1000, C=128", make(39, N=1000, rec=-1, w_scale=4, rows=128),
         ras(39, 400, 2, 128, 0.05, -3, 4), 3, 1),
        ("odd byte offset", make(38, N=200, w_scale=49, rows=14), odd_offset(torch, ras(38, 700, 3, 14, 0.2, -3, 4)),
         None, 1),
    ]
    for label, cfg, _, _, planes in cases:
        if lk.weight_planes(np.asarray(cfg.w_in)) != planes:
            fail(f"K5/K6 {label}: the case was meant to take {planes} byte planes")
    return cases


def check_k5(torch, lk, XyloConfig, dev, ucfg, u_spikes, bcfg, b_spikes, b_masks):
    make = functools.partial(make_config, XyloConfig)
    ras = functools.partial(raster, torch, dev)
    big = make(21, N=70, w_scale=400, rows=14)
    T, B, C = u_spikes.shape
    N = np.asarray(ucfg.w_in).shape[1]
    dense = ras(37, T, B, C, 0.5, -8, 9)  # the flagship's size, half the entries nonzero, values -8..8
    cases = [
        ("unipolar flagship masks", ucfg, u_spikes, 1),
        ("bipolar flagship combined raster, B=1", bcfg, b_spikes, 1),
        ("values 0..15, clip path", big, ras(21, 500, 3, 14, 0.5, 0, 16), None),
        ("negative values -20..19", make(22, N=100, rows=20), ras(22, 400, 2, 20, 0.3, -20, 20), 20),
        ("C=84", make(23, N=130, rows=84), ras(23, 600, 2, 84, 0.05, -3, 4), 3),
        ("C=128", make(24, N=200, rows=128), ras(24, 600, 2, 128, 0.05, -3, 4), 3),
        ("ragged T=12001", make(25, N=449, w_scale=49, rows=14), ras(25, 12001, 2, 14, 0.05), 1),
        ("rec_coef=-1", make(26, N=200, rec=-1, rows=14), ras(26, 1500, 4, 14, 0.2), 1),
        ("rec_coef=-1, C=128", make(27, N=300, rec=-1, rows=128), ras(27, 800, 2, 128, 0.05, -3, 4), 3),
        ("rec_coef=-1, unipolar flagship width", with_rec(ucfg, -1), u_spikes[:3000].contiguous(), 1),
        ("B=3", make(28, N=449, w_scale=49, rows=14), ras(28, 3000, 3, 14, 0.1), 1),
        ("dense, values -8..8, the flagship's size", ucfg, dense, 8),
    ] + [c[:4] for c in raster_cases(torch, lk, make, ras)]
    if lk._no_saturation_possible(big, 15, 0):
        fail("K5 clip case: the config was meant to saturate")
    worst, pack_bad, plain_ms = 0, 0, {}
    for label, cfg, spikes, bound in cases:
        pack_bad += check_raster_pack(torch, lk, spikes, label)
        got = lk.lif_count_rates(cfg, spikes, time_major=True, spike_bound=bound)
        ref, plain_ms[label] = timed_once(torch, lambda: lk.lif_count_stateful_plain(cfg, spikes)[0])
        bad = mismatches(got, ref)
        if bad:
            fail(f"K5 {label}: {bad} counts differ from the plain simulator")
        if int(ref.sum()) == 0:
            fail(f"K5 {label}: no neuron fired, the case checks nothing")
        worst = max(worst, int((got.long() - ref.long()).abs().max()))
    print(f"[K5] {len(cases)} cases bit-exact vs plain sim_hidden, the raster pack kernel bit-exact vs its plain "
          "version on each (unipolar flagship masks, bipolar combined raster, multi-count clip path, negative "
          "values, C = 1, 31, 32, 33, 64, 65, 84, 128, a bool raster, values -128 and 127, |w| = 127 and 128, "
          "weights within and beyond int16, T = 15, 16, 17, 12001, rec_coef = -1 up to N = 1000 with C = 128, "
          "an odd byte offset, B = 3, a dense raster of the flagship's size)", flush=True)
    params = lk.lif_params(ucfg, dev, spike_bound=1)  # as Demo passes them
    ms = timed_ms(torch, lambda: lk.lif_count_rates(ucfg, u_spikes, time_major=True, spike_bound=1), 20)
    params_ms = timed_ms(torch, lambda: lk.lif_count_rates(params, u_spikes, time_major=True), 20)
    # the same on the bool masks as the entry points pass them; on a dense binary raster (half the entries
    # set: the same kernel as the flagship's); and on the dense multi-valued one (its clips are not proven dead)
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    coin = lambda channels, p: (torch.rand((T, B, channels), device=dev, generator=gen) < p).to(torch.int8)  # noqa: E731
    u_bool, dense_binary = u_spikes.bool(), coin(C, 0.5)
    bool_ms = timed_ms(torch, lambda: lk.lif_count_rates(params, u_bool, time_major=True), 20)
    dense_binary_ms = timed_ms(torch, lambda: lk.lif_count_rates(params, dense_binary, time_major=True), 20)
    dense_params = lk.lif_params(ucfg, dev, spike_bound=8)
    dense_ms = timed_ms(torch, lambda: lk.lif_count_rates(dense_params, dense, time_major=True), 20)
    pack = dict(max_abs_err=float(pack_bad), ms=timed_ms(torch, lambda: lk.pack_raster(u_spikes), 20),
                plain_ms=timed_ms(torch, lambda: lk.pack_raster_plain(u_spikes), 3))
    lib, ptr = lk.library(), (lambda t: t.data_ptr())
    packed = lk.pack_raster(u_spikes)
    pack["raw_ms"] = raw_launch_ms(torch, lib.hm_lif_pack_raster, ptr(u_spikes), ptr(packed), T, packed.shape[1], B, C)
    # the one PyTorch call that computes the pack's function; timed here, used nowhere in the port
    library = lambda: torch.nn.functional.pad(  # noqa: E731
        u_spikes.transpose(0, 1), (0, packed.shape[2] - C, 0, packed.shape[1] - T))
    if mismatches(library(), packed):
        fail("raster pack: torch.nn.functional.pad of the transposed flagship raster differs from the kernel")
    pack["library_ms"] = timed_ms(torch, library, 20)
    counts = torch.empty((B, params.w_in.shape[1]), dtype=torch.int32, device=dev)
    chain_ms = raw_launch_ms(torch, lib.hm_lif_count, ptr(packed), ptr(params.w_frag), ptr(params.dash_syn),
                             ptr(params.dash_mem), ptr(params.threshold), ptr(counts),
                             *lk._raster_args(params, packed, T, counts.shape[1]))
    # the bipolar flagship through K5: the combined raster [kp & ~kn, kn] of all B rows (2C channels, two
    # k-tiles) against K3 on the same masks; K5's time with and without making the raster
    kp, kn = b_masks
    b_params = lk.lif_params(bcfg, dev, spike_bound=1)
    combine = lambda: torch.cat([kp & ~kn, kn], dim=-1)  # noqa: E731
    bad = mismatches(lk.lif_count_rates(b_params, combine(), time_major=True),
                     lk.lif_count_rates_bipolar(b_params, kp, kn))
    if bad:
        fail(f"K5 on the bipolar flagship's combined raster: {bad} counts differ from K3's")
    combined = combine()
    bipolar_ms = timed_ms(torch, lambda: lk.lif_count_rates(b_params, combined, time_major=True), 20)
    bipolar_cat_ms = timed_ms(torch, lambda: lk.lif_count_rates(b_params, combine(), time_major=True), 20)
    # timed only, at the flagship's size (the case families hold these routes to the plain simulator): int8
    # weights of more channels, three to eight k-tiles of fragments in registers, with the flagship's decays
    # and threshold and weights small enough that the clips stay proven dead; and the fragments read again
    # each group: two byte planes (one flagship weight set to 128)
    rng, channels_ms = np.random.default_rng(SEED + 60), {}
    for channels in (42, 64, 84, 128):
        w_max = min(49, 2000 // channels)
        wide = dataclasses.replace(ucfg, w_in=rng.integers(-w_max, w_max + 1, size=(channels, N)).astype(np.int32))
        wide_params, wide_raster = lk.lif_params(wide, dev, spike_bound=1), coin(channels, 0.036)
        if not wide_params.no_sat or wide_params.w_frag.shape[1:3] != (1, -(-channels // lk.RASTER_K)):
            fail(f"K5's timed case of {channels} channels was meant to take one plane with the clips proven dead")
        channels_ms[channels] = timed_ms(
            torch, lambda: lk.lif_count_rates(wide_params, wide_raster, time_major=True), 20)
    planes_params = lk.lif_params(with_weights(ucfg, {(0, 0): 128}), dev, spike_bound=1)
    if planes_params.w_frag.shape[1:3] != (2, 1):
        fail("K5's timed case of weights outside int8 was meant to take two byte planes")
    planes_ms = timed_ms(torch, lambda: lk.lif_count_rates(planes_params, u_spikes, time_major=True), 20)
    return dict(max_abs_err=float(worst), ms=ms, params_ms=params_ms, plain_ms=plain_ms["unipolar flagship masks"],
                bool_ms=bool_ms, planes_ms=planes_ms, planes_clip=not planes_params.no_sat, channels_ms=channels_ms,
                dense_binary_ms=dense_binary_ms, dense_ms=dense_ms, dense_clip=not dense_params.no_sat,
                chain_ms=chain_ms, bipolar_ms=bipolar_ms, bipolar_cat_ms=bipolar_cat_ms), pack


# ------------------------------------------------------------------ phase 12
def check_forward(torch, _build, demos, frames, n=LATENCY_SAMPLES):
    """``Demo.forward`` frame by frame: one raster pack and one K5 launch
    each, the rate equal to the batch forward's row; blocking single-frame
    latency."""
    out = {}
    for name, d in demos.items():
        d.forward(frames[0])  # warm-up
        lat = []
        for i in range(n):
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            t1 = time.perf_counter()
            doa, rate = d.forward(frames[i])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            launches = dict(_build.launch_counts)
            if launches.get("lif_k5") != 1 or launches.get("lif_pack_raster") != 1 or "lif_k3" in launches:
                fail(f"forward ({name}) frame {i} launched {launches}; expected one raster pack and one K5 launch")
            _, rate_b = d.forward_batch(frames[i:i + 1])
            if rate.shape != rate_b[0].shape or not torch.equal(rate, rate_b[0]):
                fail(f"forward ({name}) frame {i}: the rate differs from forward_batch's row")
            if not bool(torch.isfinite(rate).all()) or doa.dim() != 0:
                fail(f"forward ({name}) frame {i}: malformed output")
        out[name] = dict(latency_ms=float(np.median(lat)), latency_max_ms=max(lat))
        print(f"[forward] {name}: {n} single frames, one raster pack and one K5 launch each ({launches}), rate == "
              f"forward_batch's row", flush=True)
    return out


# ------------------------------------------------------------------ phase 13
def check_k6(torch, lk, XyloConfig, dev, ucfg, u_spikes):
    make = functools.partial(make_config, XyloConfig)
    ras = functools.partial(raster, torch, dev)
    n_cases, worst, plain_ms = 0, 0, {}

    def zeros(B, N):
        return tuple(torch.zeros((B, N), dtype=torch.int32, device=dev) for _ in range(3))

    def case(label, cfg, spikes, state0, bound=1, need_spikes=True):
        nonlocal n_cases, worst
        check_raster_pack(torch, lk, spikes, label)
        got = lk.lif_count_stateful(cfg, spikes, *state0, spike_bound=bound, time_major=True)
        ref, plain_ms[label] = timed_once(torch, lambda: lk.lif_count_stateful_plain(cfg, spikes, *state0))
        bad = sum(mismatches(a, b) for a, b in zip(got, ref))
        if bad:
            fail(f"K6 {label}: {bad} elements of counts/isyn/vmem/spk differ from the plain simulator")
        if need_spikes and int(ref[0].sum()) == 0:
            fail(f"K6 {label}: no neuron fired, the case checks nothing")
        worst = max([worst] + [int((a.long() - b.long()).abs().max()) for a, b in zip(got, ref)])
        n_cases += 1
        return got

    T, B, _ = u_spikes.shape
    N = np.asarray(ucfg.w_in).shape[1]
    first = case("unipolar flagship chunk 1", ucfg, u_spikes, zeros(B, N))
    second_in = u_spikes.flip(0).contiguous()
    second = case("unipolar flagship chunk 2, carried", ucfg, second_in, first[1:])
    whole = lk.lif_count_stateful(ucfg, torch.cat([u_spikes, second_in]), *zeros(B, N), spike_bound=1,
                                  time_major=True)
    bad = mismatches(whole[0], first[0] + second[0]) + sum(
        mismatches(a, b) for a, b in zip(whole[1:], second[1:]))
    if bad:
        fail(f"K6: two chunks carried differ from one pass of {2 * T} steps in {bad} elements")
    cfg = make(31, N=200, rows=14)
    mid = lk.lif_count_stateful_plain(cfg, ras(32, 300, 5, 14, 0.2))
    case("ragged T=777, mid-stream state", cfg, ras(31, 777, 5, 14, 0.2), mid[1:])
    sat = make(33, w_scale=5000, rows=14)
    sat.threshold[:] = 25_000
    if lk._no_saturation_possible(sat, 1, 0):
        fail("K6 saturating: the case was meant to exercise the clip path")
    mid = lk.lif_count_stateful_plain(sat, ras(34, 200, 3, 14, 0.9))
    case("saturating clip path", sat, ras(33, 301, 3, 14, 0.9), mid[1:], bound=None)
    rec = with_rec(ucfg, -1)
    head = case("rec_coef=-1, flagship width", rec, u_spikes[:3000].contiguous(), zeros(B, N))
    case("rec_coef=-1, carried", rec, u_spikes[3000:6001].contiguous(), head[1:])
    # chunks around the group of 16 steps, carried, against one pass over the same 49 steps
    state, total, lo = zeros(B, N), torch.zeros((B, N), dtype=torch.int32, device=dev), 0
    for Tc in (15, 16, 17, 1):
        out = case(f"carried chunk of {Tc}", ucfg, u_spikes[lo:lo + Tc].contiguous(), state, need_spikes=False)
        total, state, lo = total + out[0], out[1:], lo + Tc
    whole = lk.lif_count_stateful(ucfg, u_spikes[:lo].contiguous(), *zeros(B, N), spike_bound=1, time_major=True)
    bad = mismatches(whole[0], total) + sum(mismatches(a, b) for a, b in zip(whole[1:], state))
    if bad:
        fail(f"K6: chunks of 15, 16, 17, 1 carried differ from one pass of {lo} steps in {bad} elements")
    # the families around the design's edges, from mid-stream states of the plain dynamics
    for label, cfg, spikes, bound, _ in raster_cases(torch, lk, make, ras):
        mid = lk.lif_count_stateful_plain(cfg, spikes[:9].flip(0).contiguous())
        case(label + ", mid-stream state", cfg, spikes, mid[1:], bound=bound)
    print(f"[K6] {n_cases} cases bit-exact vs plain sim_hidden on counts and final isyn/vmem/spk, the raster pack "
          f"kernel on each (unipolar flagship B={B} Tc={T}, two chunks carried == one pass of {2 * T}, chunks of "
          "15, 16, 17, 1 carried == one pass, ragged T, clip path, rec_coef = -1 up to N = 1000 with C = 128, "
          "C = 1, 31, 32, 33, 64, 65, a bool raster, values -128 and 127, one to four byte planes of weights, "
          "an odd byte offset)", flush=True)
    params = lk.lif_params(ucfg, dev, spike_bound=1)  # as the streaming runtime passes them
    ms = timed_ms(torch, lambda: lk.lif_count_stateful(ucfg, second_in, *first[1:], spike_bound=1,
                                                       time_major=True), 20)
    params_ms = timed_ms(torch, lambda: lk.lif_count_stateful(params, second_in, *first[1:], time_major=True), 20)
    return dict(max_abs_err=float(worst), ms=ms, params_ms=params_ms,
                plain_ms=plain_ms["unipolar flagship chunk 2, carried"])


# ------------------------------------------------------------------ phase 14
def check_streaming_unipolar(torch, sk, lk, _build, StreamingLocalizer, udemo, frames, doas, n_chunks=4):
    sl = StreamingLocalizer(udemo)
    B, Tc, _ = frames.shape
    sl.process_chunk(sl.init_state(B), frames, return_spikes=False)  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    state, spikes = sl.init_state(B), []
    for _ in range(n_chunks):
        state, sp = sl.process_chunk(state, frames)
        spikes.append(sp)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if launches.get("lif_k6") != n_chunks or launches.get("lif_pack_raster") != n_chunks \
            or launches.get("rzcc_k1") != n_chunks or "lif_k4" in launches:
        fail(f"the unipolar streaming run launched {launches}; expected K1, the raster pack and K6 once per chunk")
    pstate = sl.init_state(B)
    for k in range(n_chunks):
        pstate, psp = plain_step(torch, sk, lk, sl, pstate, frames)
        bad = mismatches(spikes[k], psp)
        if bad:
            fail(f"unipolar streaming chunk {k}: {bad} spikes differ from the plain RZCC")
    bad = sum(mismatches(getattr(state, f), getattr(pstate, f)) for f in ("counts", "isyn", "vmem", "spk"))
    if bad:
        fail(f"unipolar streaming: {bad} elements of the LIF counts/state differ from the plain path")
    ok = ok_frac(sl.estimate_doa(state, "matched").cpu().numpy(), doas, 5.0)
    print(f"[stream-unipolar] B={B} {n_chunks} x Tc={Tc}: launches {launches}; spikes and counts identical "
          f"to the plain RZCC + plain K6; doa-ok-frac {ok:.4f} @5deg (matched)", flush=True)
    st = sl.process_chunk(sl.init_state(B), frames, return_spikes=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        st = sl.process_chunk(st, frames, return_spikes=False)
    torch.cuda.synchronize()
    return launches, dict(step_ms=(time.perf_counter() - t1) / 20 * 1e3, ok=ok)


# ------------------------------------------------------------------ phase 15
def check_k7(torch, sk, peaks, _build, dev, flagship_cs, flagship_kept):
    """K7 through ``select_by_distance_tm`` and ``rzcc_select_bipolar_tm``
    (K2) against the plain ``select_by_distance`` on the card."""
    rng = np.random.default_rng(SEED + 15)
    n_cases = 0

    def case(cand_rt, h_rt, d, label):
        nonlocal n_cases
        cand = torch.as_tensor(np.ascontiguousarray(cand_rt.T), device=dev)
        h = torch.as_tensor(np.ascontiguousarray(h_rt.T), device=dev)
        got = sk.select_by_distance_tm(cand, h, d)
        ref = sk.select_by_distance_tm_plain(cand, h, d)
        torch.cuda.synchronize()
        bad = mismatches(got, ref)
        if bad:
            fail(f"K7 {label} d={d}: {bad} elements differ from select_by_distance")
        n_cases += 1

    def bipolar_case(cs_rt, d, W, label):
        nonlocal n_cases
        cs_tm = torch.as_tensor(np.ascontiguousarray(cs_rt.T), device=dev)
        maxima, minima = (m.T.contiguous() for m in peaks.local_extrema_mask_bounded(cs_tm.T, W))
        got = sk.rzcc_select_bipolar_tm(cs_tm, maxima, minima, d)
        ref = sk.rzcc_select_bipolar_tm_plain(cs_tm, maxima, minima, d)
        torch.cuda.synchronize()
        bad = mismatches(got[0], ref[0]) + mismatches(got[1], ref[1])
        if bad:
            fail(f"rzcc_select_bipolar_tm {label} d={d}: {bad} elements differ from select_by_distance")
        n_cases += 1

    # the case families of tests/test_pallas_suppress.py
    for _ in range(3):
        x = np.cumsum(rng.standard_normal((5, 400)).astype(np.float32), axis=-1)
        cand = peaks.local_maxima_mask(torch.as_tensor(x)).numpy()
        for d in (1, 3, 7, 12):
            case(cand, x, d, "random cumsum")
    dense = rng.standard_normal((3, 257)).astype(np.float32)
    for d in (2, 5, 11):
        case(np.ones_like(dense, bool), dense, d, "dense chains")
    long_dense = rng.standard_normal((5, 3000)).astype(np.float32)
    for d in (11, 40):
        case(np.ones_like(long_dense, bool), long_dense, d, "dense chains across tiles")
    h = np.zeros((1, 64), np.float32)
    cand = np.zeros((1, 64), bool)
    h[0, [10, 15, 40, 45, 50]] = 1.0
    cand[0, [10, 15, 40, 45, 50]] = True
    for d in (6, 11, 40):
        case(cand, h, d, "exact ties")
    ragged = np.cumsum(rng.standard_normal((9, 203)).astype(np.float32), axis=-1)
    case(peaks.local_maxima_mask(torch.as_tensor(ragged)).numpy(), ragged, 5, "ragged")
    case(np.zeros((1, 100), bool), np.linspace(0, 1, 100, dtype=np.float32)[None, :], 5, "empty")
    # wide windows: the widest the shared memory takes, and one past it
    t = np.arange(4000, dtype=np.float32)
    drift = np.cumsum(np.sin(2 * np.pi * t / 900.0)[None, :]
                      + 0.3 * rng.standard_normal((3, 4000)).astype(np.float32), axis=-1)
    drift_max = peaks.local_maxima_mask(torch.as_tensor(drift)).numpy()
    d_max = widest_distance(sk)
    for d in (24, 80, 120, d_max):
        case(drift_max, drift, d, "wide window")
    must_raise_too_wide(lambda: sk.select_by_distance_tm(torch.as_tensor(drift_max.T.copy(), device=dev),
                                                         torch.as_tensor(drift.T.copy(), device=dev), d_max + 1),
                        f"K7 d={d_max + 1}")
    # the word layout's edges: candidates at t = 0 and t = T - 1 with T and
    # the tiles ending mid-word, rows in (36) and out of (37) the
    # four-rows-a-word path, all-candidate rows beside empty rows in one warp,
    # masks at an odd byte offset
    for rows, T in ((36, sk.TB + 13), (37, 2 * sk.TB + 45), (3, 33)):
        eh = rng.standard_normal((rows, T)).astype(np.float32)
        ec = rng.random(eh.shape) < 0.05
        ec[:, [0, -1]] = True
        for d in (5, 12, 33, 65):
            case(ec, eh, d, f"candidates at both ends {rows}x{T}")
    mixed_h = rng.standard_normal((36, sk.TB + 200)).astype(np.float32)
    mixed_c = np.ones_like(mixed_h, bool)
    mixed_c[1::2] = False
    for d in (11, 40):
        case(mixed_c, mixed_h, d, "dense rows beside empty rows")
    odd_h = torch.as_tensor(np.ascontiguousarray(mixed_h.T), device=dev)
    cand_tm = torch.as_tensor(np.ascontiguousarray(mixed_c.T), device=dev)
    act, kept = odd_offset(torch, cand_tm), odd_offset(torch, torch.zeros_like(cand_tm))
    while True:  # K7 itself on masks at an odd byte offset: one byte a row, not four rows a word
        act, flags = sk.suppress_k7(odd_h, act, kept, 11)
        act = odd_offset(torch, act)
        if not bool(flags.any()):
            break
    if mismatches(kept, sk.select_by_distance_tm_plain(cand_tm, odd_h, 12)):
        fail("K7 masks at an odd byte offset: differs from select_by_distance")
    n_cases += 1
    inf_h = drift.copy()
    inf_h[0, np.flatnonzero(drift_max[0])[0]] = -np.inf
    try:
        sk.select_by_distance_tm(torch.as_tensor(drift_max.T.copy(), device=dev),
                                 torch.as_tensor(inf_h.T.copy(), device=dev), 12)
        fail("K7: a candidate with a non-finite height did not raise")
    except ValueError:
        pass
    for d, W in ((3, 6), (7, 14), (12, 24)):
        bipolar_case(np.cumsum(rng.standard_normal((6, 500)).astype(np.float32), axis=-1), d, W, "random")
    bipolar_case(drift, 80, 24, "wide window")

    # the flagship cs: maxima with heights cs; the main path of K7 is one
    # select_by_distance_tm call
    T, R = flagship_cs.shape
    w, W = sk._windows(12, 24)
    maxima, minima = (m.T.contiguous() for m in peaks.local_extrema_mask_bounded(flagship_cs.T, W))
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    kept = sk.select_by_distance_tm(maxima, flagship_cs, 12)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if launches.get("suppress_k7", 0) < 1 or set(launches) != {"suppress_k7"}:
        fail(f"select_by_distance_tm on the flagship launched {launches}; expected K7 only")
    bad = mismatches(kept, flagship_kept[0])
    kp, kn = sk.rzcc_select_bipolar_tm(flagship_cs, maxima, minima, 12)
    bad_b = mismatches(kp, flagship_kept[0]) + mismatches(kn, flagship_kept[1])
    if bad or bad_b:
        fail(f"flagship cs: K7 kept differs from rzcc_encode_bipolar_tm's kept_pos in {bad} elements, "
             f"rzcc_select_bipolar_tm from its outputs in {bad_b}")
    # one K7 launch (round 1 from the maxima) against one plain round
    act1, kept1 = maxima, torch.zeros_like(maxima)
    act2, _ = sk.suppress_k7(flagship_cs, act1, kept1, w)
    ref_act, ref_kept = sk._k7_plain(flagship_cs, act1, torch.zeros_like(maxima), w)
    launch_bad = mismatches(act2, ref_act) + mismatches(kept1, ref_kept)
    if launch_bad:
        fail(f"flagship cs: one K7 launch differs from one plain round in {launch_bad} elements")
    n_cases += 1
    print(f"[K7] {n_cases} cases bit-exact vs plain select_by_distance (random cumsums, dense chains, exact ties, "
          f"ragged, empty, word and tile edges, windows up to d = {d_max}; d = {d_max + 1} and a -inf candidate height "
          f"raise); flagship maxima "
          f"{T}x{R}: launches {launches}, kept == rzcc_encode_bipolar_tm's kept_pos, rzcc_select_bipolar_tm "
          "== both outputs", flush=True)
    ms = timed_ms(torch, lambda: sk.suppress_k7(flagship_cs, maxima, kept1, w), 20)
    plain_ms = timed_ms(torch, lambda: sk._k7_plain(flagship_cs, maxima, ref_kept, w), 5)
    call_ms = timed_ms(torch, lambda: sk.select_by_distance_tm(maxima, flagship_cs, 12), 20)
    call_plain_ms = timed_ms(torch, lambda: sk.select_by_distance_tm_plain(maxima, flagship_cs, 12), 5)
    lib, ptr = sk.library(), (lambda t: t.data_ptr())
    flags = torch.empty((-(-T // sk.TB), -(-R // lib.hm_rzcc_rows_per_block())), dtype=torch.int32, device=dev)
    raw_ms = raw_launch_ms(torch, lib.hm_suppress_k7, ptr(flagship_cs), ptr(maxima), ptr(act2), ptr(kept1),
                           ptr(flags), T, R, w, sk._margin(w), sk.TB)
    return launches, dict(max_abs_err=float(launch_bad), ms=ms, plain_ms=plain_ms, raw_ms=raw_ms,
                          call_ms=call_ms, call_plain_ms=call_plain_ms)


# ------------------------------------------------------------------ phase 16
def check_probes(torch, rk, lk, dev, flagship_config, flagship_masks):
    """P1 and P2 against their plain versions at small sizes; P3 against K3.
    The harness (phase 17) holds P1 and P2 again at the shapes it times."""
    rng = np.random.default_rng(SEED + 16)
    n_cases = 0
    for shape, iters, ilp, threads, blocks in (((8, 512), 64, 1, 256, None), ((8, 512), 64, 2, 128, None),
                                              ((3, 1000), 100, 4, 64, None), ((4096,), 37, 8, 128, 5),
                                              ((5000,), 20, 1, 64, 200)):
        x = torch.as_tensor(rng.integers(-1000, 1000, size=shape).astype(np.int32), device=dev)
        got = rk.lif_peak(x, iters, ilp, threads, blocks)
        torch.cuda.synchronize()
        bad = mismatches(got, rk.lif_peak_plain(x, iters))
        if bad:
            fail(f"P1 {shape} iters={iters} ilp={ilp}: {bad} elements differ from the plain version")
        n_cases += 1
    for nb, w, rep in ((3, 5, 2), (2, 1, 3), (2, 11, 3), (1, 24, 2), (2, 40, 1)):
        x = torch.as_tensor(rng.standard_normal((nb, rk.P2_TBE, rk.P2_ROWS)).astype(np.float32), device=dev)
        got = rk.shiftmax(x, w, rep)
        torch.cuda.synchronize()
        bad = mismatches(got.view(torch.int32), rk.shiftmax_plain(x, w, rep).view(torch.int32))
        if bad:
            fail(f"P2 {tuple(x.shape)} w={w} rep={rep}: {bad} elements differ from the plain version")
        n_cases += 1
    kp, kn = flagship_masks
    ref = lk.lif_count_rates_bipolar(flagship_config, kp, kn, spike_bound=1)
    for k in (2, 4):
        bad = mismatches(rk.lif_count_kstep(flagship_config, kp, kn, k), ref)
        if bad:
            fail(f"P3 k={k}: {bad} flagship counts differ from K3's")
        n_cases += 1
    r = np.random.default_rng(SEED + 161)
    rkp = torch.as_tensor(r.random((1001, 3, 14)) < 0.05, device=dev)
    rkn = torch.as_tensor(r.random((1001, 3, 14)) < 0.05, device=dev)
    ref = lk.lif_count_plain(flagship_config, rkp, rkn)
    bad = mismatches(rk.lif_count_kstep(flagship_config, rkp, rkn, 4), ref)
    if bad or int(ref.sum()) == 0:
        fail(f"P3 ragged T=1001 B=3: {bad} counts differ from the plain simulator (sum {int(ref.sum())})")
    n_cases += 1
    print(f"[probes] {n_cases} cases: P1 and P2 bit-exact vs their plain versions (ILP 1-8, ragged launches, "
          "w 1-40); P3 counts == K3's on the flagship masks (k = 2, 4) and == the plain "
          "simulator on ragged T", flush=True)


# ------------------------------------------------------------------ phase 17
def run_roofline(torch, roofline, _build, flagship_config, flagship_masks, w, card):
    """The harness's ceilings and P3 against K3, short: P1 and P2 held
    bit-exact against their plain versions at the shapes timed, P3's counts
    against K3's; the probes' launch counts are read from this run."""
    kp, kn = flagship_masks
    T, B, _ = kp.shape
    N = np.asarray(flagship_config.w_in).shape[1]
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    ceil = roofline.ceilings(reps=3, k3_shape=roofline.k3_launch_shape(B, kp.shape[-1], N, T), w=w)
    p3 = roofline.p3_against_k3(flagship_config, kp, kn, reps=10)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    for name in ("probe_p1", "probe_p2", "probe_p3"):
        if launches.get(name, 0) < 1:
            fail(f"the roofline run never launched {name} (launch counts {launches})")
    g, p1, p2 = ceil["guide"], ceil["p1"], ceil["p2"]
    b, k3s = p1["best"], p1["k3_shape"]
    if b["mismatches"] or p2["mismatches"] or p3["k2_max_abs_err"] or p3["k4_max_abs_err"]:
        fail(f"the harness's shapes: P1 differs from its plain version in {b['mismatches']} elements, P2 in "
             f"{p2['mismatches']}; P3's counts from K3's by up to {p3['k2_max_abs_err']} (k=2), "
             f"{p3['k4_max_abs_err']} (k=4)")
    tag = f"[roofline] [{card}]"
    print(f"{tag} guide peaks ({g['sms']} SMs at {g['sm_clock_mhz']:.0f} MHz): int32 "
          f"{g['int32_ops_per_s'] / 1e12:.3f} Tops/s, compares {g['compares_per_s'] / 1e12:.3f} T/s")
    print(f"{tag} P1 ceiling {b['ops_per_s'] / 1e12:.3f} Tops/s (10 nominal per step; ILP {b['ilp']}, "
          f"{b['blocks']} x {b['threads']} threads, {b['iters']} steps, {b['ms']:.3f} ms; bit-exact vs plain); "
          f"at K3's launch shape ({k3s['blocks']} x {k3s['threads']}, one chain each, {k3s['iters']} steps) "
          f"{k3s['ops_per_s'] / 1e12:.3f} Tops/s in {k3s['ms']:.3f} ms")
    print(f"{tag} P2 executes {p2['compares_per_s'] / 1e12:.3f} T compares/s (w={p2['w']}, TBe={p2['tbe']}, "
          f"rep={p2['rep']}, {p2['blocks']} blocks, {p2['ms']:.3f} ms; bit-exact vs plain)")
    print(f"{tag} P3 vs K3 at the flagship: k=2 {p3['k2_ms']:.3f} ms, k=4 {p3['k4_ms']:.3f} ms, K3 "
          f"{p3['k3_ms']:.3f} ms (counts exact)", flush=True)
    return launches, dict(ceil=ceil, p3=p3)


# ------------------------------------------------------------------ phase 18
def decimated(torch, resample, frames, factor: int = 2):
    """(B, T, M) frames decimated by ``decimate_fir(x, factor)`` frame by
    frame, as the JAX package's reduced-rate experiment feeds its 24 kHz
    model."""
    x = frames.cpu().numpy()
    return torch.as_tensor(np.stack([resample.decimate_fir(f, factor) for f in x]), device=frames.device)


def host_ms(torch, fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` by the host clock around ``reps`` calls
    that end in a synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) / reps * 1e3


def plain_estimates(torch, sk, lk, demo, frames, methods):
    """The plain path on the same frames and card: encode, the plain RZCC,
    the plain LIF (by rows); {method: DoAs}, ``cs``, the plain masks and
    counts, and the plain LIF's milliseconds."""
    cs = demo.encode(frames)
    T, B, C = cs.shape
    kp, kn = sk.rzcc_encode_bipolar_tm_plain(cs.reshape(T, B * C), demo.robust_width, 2 * demo.robust_width)
    kp, kn = kp.reshape(T, B, C), kn.reshape(T, B, C)
    (counts, *_), plain_ms = timed_once(torch, lambda: plain_bipolar_rows(torch, lk, demo.xylo_config, kp, kn))
    return {m: demo.estimate(counts, T, m)[0] for m in methods}, cs, (kp, kn), counts, plain_ms


def check_24k(torch, sk, lk, _build, Demo, StreamingLocalizer, resample, flagship, frames48, doas):
    """The bipolar flagship at 24 kHz on the bundled design and table:
    ``forward_batch(matched)`` on bench.py's frames decimated by 2 (DoAs =
    the plain path's, the gate 1.00 @5 deg), and the 96-stream step over two
    carried 6000-sample chunks (spikes, counts and state = the plain path's
    and = one K4 pass over the same masks; the gate)."""
    demo = Demo(**{**flagship, "fs": 24_000})  # the bundled 24 kHz design
    demo.calibrate_profiles()  # the bundled 24 kHz table
    frames = decimated(torch, resample, frames48)
    B, T, _ = frames.shape
    demo.forward_batch(frames, method="matched")  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    doa, rate = demo.forward_batch(frames, method="matched")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if launches.get("rzcc_k1") != 1 or launches.get("lif_pack") != 1 or launches.get("lif_k3") != 1:
        fail(f"the 24 kHz batch launched {launches}; expected K1, the pack pass and K3 once each")
    p_doa, *_ = plain_estimates(torch, sk, lk, demo, frames, ("matched",))
    if not torch.equal(doa, p_doa["matched"]):
        fail("24 kHz: the DoAs differ from the plain path's")
    ok = ok_frac(doa.cpu().numpy(), doas, 5.0)
    print(f"[24k] B={B} T={T} (bench.py's frames decimated by 2): launches {launches}; DoAs identical to the plain "
          f"path; doa-ok-frac {ok:.2f} @5deg (matched)", flush=True)
    if ok < 1.0:
        fail(f"24 kHz accuracy gate failed: doa-ok-frac {ok:.2f} @5deg")

    sl = StreamingLocalizer(demo)
    Tc = T
    if sl.block_size(Tc) != 48:
        fail(f"24 kHz: chunks of {Tc} samples take the lifted block size {sl.block_size(Tc)}, not 48")
    sl.process_chunk(sl.init_state(B), frames, return_spikes=False)  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    state, spikes = sl.init_state(B), []
    for _ in range(2):
        state, sp = sl.process_chunk(state, frames)
        spikes.append(sp)
    torch.cuda.synchronize()
    s_launches = dict(_build.launch_counts)
    if s_launches.get("lif_k4") != 2 or s_launches.get("lif_pack") != 2 or s_launches.get("rzcc_k1") != 2:
        fail(f"the 24 kHz streaming run launched {s_launches}; expected K1, the pack pass and K4 once per chunk")
    pstate = sl.init_state(B)
    for k in range(2):
        pstate, psp = plain_step(torch, sk, lk, sl, pstate, frames)
        if mismatches(spikes[k], psp):
            fail(f"24 kHz streaming chunk {k}: spikes differ from the plain RZCC")
    fields = ("counts", "isyn", "vmem", "spk")
    bad = sum(mismatches(getattr(state, f), getattr(pstate, f)) for f in fields)
    raster = torch.cat(spikes)
    C = raster.shape[-1] // 2
    zeros = tuple(torch.zeros_like(state.isyn) for _ in range(3))
    one = lk.lif_count_stateful_bipolar(demo.lif_params(), (raster[..., :C] != 0).contiguous(),
                                        (raster[..., C:] != 0).contiguous(), *zeros)
    bad_one = sum(mismatches(getattr(state, f), o) for f, o in zip(fields, one))
    if bad or bad_one:
        fail(f"24 kHz streaming: the counts/state differ from the plain path in {bad} elements, from one K4 pass "
             f"over the two chunks' masks in {bad_one}")
    s_ok = ok_frac(sl.estimate_doa(state, "matched").cpu().numpy(), doas, 5.0)
    print(f"[24k] streaming B={B} 2 x Tc={Tc} (lifted block 48): launches {s_launches}; spikes, counts and state "
          f"identical to the plain path and to one K4 pass over both chunks; doa-ok-frac {s_ok:.2f} @5deg (matched)",
          flush=True)
    if s_ok < 1.0:
        fail(f"24 kHz streaming accuracy gate failed: doa-ok-frac {s_ok:.2f} @5deg")
    st = [sl.process_chunk(sl.init_state(B), frames, return_spikes=False)]

    def step():
        st[0] = sl.process_chunk(st[0], frames, return_spikes=False)

    return dict(batch_ms=host_ms(torch, lambda: demo.forward_batch(frames, method="matched"), 20),
                step_ms=host_ms(torch, step, 20), ok=ok, stream_ok=s_ok, B=B, T=T)


# ------------------------------------------------------------------ phase 19
STACKED_METHODS = ("matched", "peak", "matched_stacked", "matched_auto")
MULTIBAND_REPS = 20  # multiband_bench's timed calls (JAX's harness: 100)


def check_multiband(torch, sk, lk, _build, Demo, StreamingLocalizer, server, resample, mulaw, roofline, mb,
                    multiband_bench, dev, fs, peaks_per_s, serve: bool):
    """The three-band model of experiments/multiband_bench.py at ``fs``:
    designed on the card (``use_cache=False``, timed), calibrated folded and
    band-stacked from the wideband template; ``forward_batch`` with the four
    estimators (DoAs = the plain path's; gate 1.00 @5 deg matched, the
    others' ok-fractions printed); K1/K2 at R = B·C =
    4032 and the pack pass and K3 at C = 42, N = 1347 bit-exact against their
    plain versions (all 96 rows, the plain LIF 32 rows at a time); one
    96-stream step (K4) bit-exact in spikes, counts and state; with
    ``serve`` one daemon round by ``matched_stacked``; then
    ``experiments/multiband_bench.run`` on this model and these frames."""
    cfg = mb.multiband_config(dev, fs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    demo = Demo(**cfg, use_cache=False)
    torch.cuda.synchronize()
    design_s = time.perf_counter() - t0
    frames, doas, template = mb.multiband_frames(demo, 96, seed=SEED)
    t0 = time.perf_counter()
    demo.calibrate_profiles(template=template, use_cache=False)
    demo.calibrate_profiles(template=template, use_cache=False, band_stacked=True)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    B, T, _ = frames.shape
    N = demo.xylo_config.w_in.shape[1]
    tag = f"[3-band {fs // 1000} kHz]"

    demo.forward_batch(frames, method="matched")  # warm-up
    torch.cuda.synchronize()
    got, launches = {}, {}
    for m in STACKED_METHODS:
        _build.launch_counts.clear()
        got[m] = demo.forward_batch(frames, method=m)
        torch.cuda.synchronize()
        launches[m] = dict(_build.launch_counts)
        if launches[m].get("rzcc_k1") != 1 or launches[m].get("lif_pack") != 1 or launches[m].get("lif_k3") != 1:
            fail(f"{tag} forward_batch({m}) launched {launches[m]}; expected K1, the pack pass and K3 once each")
    p_doa, cs, (p_kp, p_kn), p_counts, k3_plain_ms = plain_estimates(torch, sk, lk, demo, frames, STACKED_METHODS)
    bad = [m for m in STACKED_METHODS if not torch.equal(got[m][0], p_doa[m])]
    if bad:
        fail(f"{tag}: the DoAs of {bad} differ from the plain path's")
    tol = {m: 25.0 if m == "peak" else 5.0 for m in STACKED_METHODS}
    ok = {m: ok_frac(got[m][0].cpu().numpy(), doas, tol[m]) for m in STACKED_METHODS}
    # the frames outside each estimator's tolerance: (frame, folded error in degrees)
    misses = {}
    for m in STACKED_METHODS:
        err = np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(got[m][0].cpu().numpy() - doas)))))
        misses[m] = [(int(i), round(float(err[i]), 1)) for i in np.flatnonzero(err >= tol[m])]

    # K1/K2 at R = 4032: the wrapper's masks, K1 and one K2 launch against the plain versions
    C = cs.shape[-1]
    cs_tm = cs.reshape(T, B * C)
    w, W = sk._windows(demo.robust_width, 2 * demo.robust_width)
    kp, kn = demo.rzcc(cs)
    k1 = sk.rzcc_k1(cs_tm, w, W)
    k1_ref = sk._k1_plain(cs_tm, w, W)
    kept_p, kept_n = k1[2].clone(), k1[3].clone()
    ap, an, _ = sk.rzcc_k2(cs_tm, k1[0], k1[1], kept_p, kept_n, w)
    k2_ref = sk._k2_plain(cs_tm, *k1_ref, w)
    rz_bad = (mismatches(kp, p_kp) + mismatches(kn, p_kn), sum(mismatches(a, b) for a, b in zip(k1, k1_ref)),
              sum(mismatches(a, b) for a, b in zip((ap, an, kept_p, kept_n), k2_ref)))
    if any(rz_bad):
        fail(f"{tag} K1/K2 at R={B * C}: the wrapper's masks, K1 and one K2 launch differ from the plain "
             f"versions in {rz_bad} elements")
    # the pack pass and K3 at C = 42, N = 1347 (the kernels' counts on all rows)
    params = demo.lif_params()
    check_pack(torch, lk, kp, kn, f"{tag} C={C}")
    counts = lk.lif_count_rates_bipolar(params, kp, kn)
    if mismatches(counts, p_counts):
        fail(f"{tag} K3 at C={C} N={N}: counts differ from the plain simulator")
    print(f"{tag} designed on the card in {design_s:.3f} s (w_in {tuple(demo.xylo_config.w_in.shape)}), calibrated "
          f"folded and band-stacked in {calib_s:.3f} s; B={B} T={T}: launches {launches['matched']}; DoAs of "
          f"{', '.join(STACKED_METHODS)} identical to the plain path; K1/K2 at R={B * C}, the pack pass and K3 at "
          f"C={C} N={N} bit-exact on all rows; doa-ok-frac {ok['matched']:.2f} @5deg (matched), {ok['peak']:.2f} "
          f"@25deg (peak), matched_stacked {ok['matched_stacked']:.2f} @5deg, matched_auto "
          f"{ok['matched_auto']:.2f} @5deg", flush=True)
    print(f"{tag} frames outside the tolerance (frame, folded error deg): {misses}", flush=True)
    # the gate is the matched estimator's, as bench.py's; the reference-parity peak estimator is held to
    # the plain path's DoAs above and its ok-fraction printed (as phase 5 does for the flagship's): the
    # JAX package's 1.00 @25deg at F = 3 (RESULTS.md:17) was one noise realization
    if ok["matched"] < 1.0:
        fail(f"{tag} accuracy gate failed: doa-ok-frac {ok['matched']:.2f} @5deg (matched)")

    # one 96-stream step on the 0.25 s frames: K4 from zero against the plain step
    sl = StreamingLocalizer(demo)
    sl.process_chunk(sl.init_state(B), frames, return_spikes=False)  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    state, spikes = sl.process_chunk(sl.init_state(B), frames)
    torch.cuda.synchronize()
    s_launches = dict(_build.launch_counts)
    if s_launches.get("lif_k4") != 1 or s_launches.get("lif_pack") != 1:
        fail(f"{tag} streaming step launched {s_launches}; expected the pack pass and K4 once")
    pstate, psp = plain_step(torch, sk, lk, sl, sl.init_state(B), frames)
    bad = mismatches(spikes, psp) + sum(mismatches(getattr(state, f), getattr(pstate, f))
                                        for f in ("counts", "isyn", "vmem", "spk"))
    if bad:
        fail(f"{tag} streaming step: {bad} elements of the spikes/counts/state differ from the plain step")
    st_doa = sl.estimate_doa(state, "matched_stacked")
    print(f"{tag} 96-stream step: launches {s_launches}; spikes, counts and state identical to the plain step; "
          f"doa-ok-frac {ok_frac(st_doa.cpu().numpy(), doas, 5.0):.2f} @5deg (matched_stacked, after one chunk "
          f"of {T} samples, {sl.pending} of them still pending)", flush=True)
    if serve:
        check_serving(torch, _build, StreamingLocalizer, server, resample, mulaw, demo, frames, n_chunks=1,
                      wires=(("f32", 1),), method="matched_stacked")
    # experiments/multiband_bench.py on this model and these frames (its design and calibration are the above)
    bench, bench_launches = counted(torch, _build, f"{tag} multiband_bench", XYLO_PATH,
                                    lambda: multiband_bench.run(demo=demo, frames=(frames, doas), n_rep=MULTIBAND_REPS))
    if bench["doa_ok_frac_matched_5deg"] < 1.0:
        fail(f"{tag} multiband_bench: doa-ok-frac {bench['doa_ok_frac_matched_5deg']:.2f} @5deg (matched)")
    print(f"{tag} multiband_bench.run on this model and these frames ({MULTIBAND_REPS} calls): {json.dumps(bench)}; "
          f"launches {bench_launches}", flush=True)

    # what the chain meets at C = 42: steps by set bits, tiles of 32 and chunks of CHAIN_STAGE steps by the most
    # set bits a step of theirs has (at most 4: four slots a step; 5-6: six; more: the mask words)
    packed = lk.pack_bipolar_masks(kp, kn)
    bits = (torch.cat([kp & ~kn, kn], dim=-1) != 0).sum(dim=-1)
    tiles = packed.most[:, :-(-T // 32)]
    chunks = torch.zeros((B, -(-T // CHAIN_STAGE) * (CHAIN_STAGE // 32)), dtype=tiles.dtype, device=dev)
    chunks[:, :tiles.shape[1]] = tiles
    chunks = chunks.reshape(B, -1, CHAIN_STAGE // 32).amax(dim=-1)
    hist = dict(steps_by_bits=torch.bincount(bits.flatten()).tolist(), tiles=tiles.numel(),
                tiles_over_6=int((tiles > 6).sum()), tiles_5_6=int(((tiles > 4) & (tiles <= 6)).sum()),
                chunks=chunks.numel(), chunks_words=int((chunks > 6).sum()),
                chunks_six=int(((chunks > 4) & (chunks <= 6)).sum()))
    print(f"{tag} K3's input: steps (of B*T) by set bits {hist['steps_by_bits']}; tiles of 32 steps {hist['tiles']}, "
          f"with a step of 5-6 set bits {hist['tiles_5_6']}, of more than 6 (the word loop) {hist['tiles_over_6']}; "
          f"chunks of {CHAIN_STAGE} steps {hist['chunks']}, on six slots {hist['chunks_six']}, on the mask words "
          f"{hist['chunks_words']}", flush=True)

    # times and bounds
    k4_state = tuple(torch.zeros((B, N), dtype=torch.int32, device=dev) for _ in range(3))
    combined = torch.cat([kp & ~kn, kn], dim=-1)
    if mismatches(lk.lif_count_rates(params, combined, time_major=True), counts):
        fail(f"{tag}: K5 on the combined raster differs from K3's counts")
    st = [sl.init_state(B)]

    def step():
        st[0] = sl.process_chunk(st[0], frames, return_spikes=False)

    k1_ms = timed_ms(torch, lambda: sk.rzcc_k1(cs_tm, w, W), 20)
    k2_ms = timed_ms(torch, lambda: sk.rzcc_k2(cs_tm, k1[0], k1[1], k1[2], k1[3], w), 20)
    times = dict(
        design_s=design_s, calib_s=calib_s,
        batch_ms=host_ms(torch, lambda: demo.forward_batch(frames, method="matched"), 10),
        stacked_batch_ms=host_ms(torch, lambda: demo.forward_batch(frames, method="matched_stacked"), 10),
        step_ms=host_ms(torch, step, 10),
        k1_ms=k1_ms, k2_ms=k2_ms,
        pack_ms=timed_ms(torch, lambda: lk.pack_bipolar_masks(kp, kn), 20),
        k3_ms=timed_ms(torch, lambda: lk.lif_count_rates_bipolar(demo.xylo_config, kp, kn, spike_bound=1), 10),
        k3_params_ms=timed_ms(torch, lambda: lk.lif_count_rates_bipolar(params, kp, kn), 10),
        k3_plain_ms=k3_plain_ms,
        k4_ms=timed_ms(torch, lambda: lk.lif_count_stateful_bipolar(demo.xylo_config, kp, kn, *k4_state), 10),
        k4_params_ms=timed_ms(torch, lambda: lk.lif_count_stateful_bipolar(params, kp, kn, *k4_state), 10),
        k5_combined_ms=timed_ms(torch, lambda: lk.lif_count_rates(params, combined, time_major=True), 10),
        k5_cat_ms=timed_ms(torch, lambda: lk.lif_count_rates(params, torch.cat([kp & ~kn, kn], dim=-1),
                                                             time_major=True), 10),
    )
    work = {**roofline.rzcc_work(cs_tm, w, W), **roofline.lif_bipolar_work(kp, kn, N)}
    times["bounds"] = {k: dict(zip(("bound_ms", "bound_by", "ops", "bytes"), (*b, *work[k])))
                       for k, b in roofline.bounds(work, peaks_per_s).items()}
    times.update(bench=bench, bench_launches=bench_launches)
    return times

# ------------------------------------------------------------------ phase 20
# the accuracy each family's JAX test asks for, by the folded metric
# arcsin|sin(est - true)| in degrees: tests/test_beamformer.py:110,
# tests/test_music.py:127, tests/test_srp_phat.py:57
FAMILY_GATE_DEG = {"hilbert": 3.0, "music": 4.0, "srp": 3.0}
# the card's profiles against the port's CPU path on the same frames, as a
# fraction of each row's peak: the Hilbert path's order-2 1600-1900 Hz
# bandpass amplifies float32 rounding about a thousandfold (1e-4 between the
# JAX package and the port on the CPU), MUSIC's order-1 one does not; the
# SRP power is bounded by 1 and PHAT-whitens tiny cross-spectra
FAMILY_RTOL = {"hilbert": 1e-3, "music": 1e-4, "srp": 5e-4}
HILBERT_CHUNK = 48  # frames a Beamformer.apply_to_signal call: its (48, T, 449) complex64 output is 2.1 GB


def folded_deg(a, b):
    return np.rad2deg(np.arcsin(np.abs(np.sin(np.asarray(a) - np.asarray(b)))))


def wrapped_deg(a, b):
    d = np.asarray(a) - np.asarray(b)
    return np.rad2deg(np.abs(np.arctan2(np.sin(d), np.cos(d))))


def batched(torch, fn, frames, chunk):
    return torch.cat([fn(frames[i:i + chunk]) for i in range(0, frames.shape[0], chunk)])


def top_two_margin(prof):
    """(B,) relative gap between each row's largest and second-largest value."""
    top2 = prof.topk(2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()).numpy()


def mix_frames(torch, interp, geo, sources, n, T, fs, seed, sign):
    """(n, T, M) float32 frames of equal tones from ``sources`` [(doa, freq)]
    plus 0.1 white noise, from a seed, synthesized in float64 on the host."""
    rng = np.random.default_rng(seed)
    t = torch.arange(T, dtype=torch.float64) / fs
    out = []
    for _ in range(n):
        x = sum(interp.signal_from_template(geo, t, torch.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)), d,
                                            fs=fs, delay_sign=sign) for d, f in sources)
        out.append(x.numpy() + 0.1 * rng.standard_normal(x.shape))
    return np.stack(out).astype(np.float32)


def run_cli(localize, argv):
    """``localize.main(argv)`` → its exit code and JSON lines."""
    import contextlib
    import io as _io

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = localize.main(argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]


def check_families(torch, _build, server, StreamingLocalizer, demo, frames, doas, dev):
    """Phase 20: the classical families, the trackers, the offline localizer
    and multi-source serving on the card at the flagship's width."""
    from haghighatshoarmuir2024_tpu_torch.models.beamformer import Beamformer, analytic
    from haghighatshoarmuir2024_tpu_torch.models.music import MUSIC
    from haghighatshoarmuir2024_tpu_torch.models.srp_phat import SRPPHAT
    from haghighatshoarmuir2024_tpu_torch.ops import interp
    from haghighatshoarmuir2024_tpu_torch.ops.iir import iir_filter
    from haghighatshoarmuir2024_tpu_torch.ops.peaks import top_k_peaks
    from haghighatshoarmuir2024_tpu_torch.tools import localize
    from haghighatshoarmuir2024_tpu_torch.utils.tracking import MultiDoaTracker

    geo, grid, fs, band = demo.geometry, demo.doa_list, int(demo.fs), [1600.0, 1900.0]
    B, T, M = frames.shape
    G = len(grid)
    frame = T / fs
    out = {}

    # ---- the Hilbert design on the card, plain and with interference removal
    tt = np.arange(0, frame, 1 / fs)
    tpl = (tt, np.sin(2 * np.pi * 1750 * tt))
    bf = Beamformer(geo, 10e-3, band, fs=fs, device=dev)
    bf.design_from_template(tpl, grid)  # warm-up: cuFFT/cuSOLVER plans, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf_mat, _ = bf.design_from_template(tpl, grid)
    torch.cuda.synchronize()
    out["design_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf_ir, _ = bf.design_from_template(tpl, grid, interference_removal=True)
    torch.cuda.synchronize()
    out["design_ir_s"] = time.perf_counter() - t0
    for name, m in (("plain", bf_mat), ("interference removal", bf_ir)):
        norms = torch.linalg.vector_norm(m, dim=0)
        if m.shape != (M, G) or not bool(torch.isfinite(torch.view_as_real(m)).all()) \
                or float((norms - 1).abs().max()) > 1e-4:
            fail(f"Hilbert design ({name}) malformed: shape {tuple(m.shape)}, norms {norms.min()}..{norms.max()}")

    # ---- the three families on the flagship's 96 frames, card and CPU
    music = MUSIC(geo, band, grid, frame_duration=frame, fs=fs, device=dev)
    srp = SRPPHAT(geo, band, grid, fs=fs, frame_duration=frame, device=dev)
    cpu = torch.device("cpu")
    bf_cpu = Beamformer(geo, 10e-3, band, fs=fs, device=cpu)
    music_cpu = MUSIC(geo, band, grid, frame_duration=frame, fs=fs, device=cpu)
    srp_cpu = SRPPHAT(geo, band, grid, fs=fs, frame_duration=frame, device=cpu)
    bf_mat_cpu = bf_mat.cpu()
    power = lambda b, m: (lambda x: (b.apply_to_signal(m, x).abs() ** 2).mean(dim=1))
    fams = {
        "hilbert": (lambda x: batched(torch, power(bf, bf_mat), x, HILBERT_CHUNK),
                    lambda x: batched(torch, power(bf_cpu, bf_mat_cpu), x, HILBERT_CHUNK)),
        "music": (lambda x: music.beamforming(x, 2, 2048), lambda x: music_cpu.beamforming(x, 2, 2048)),
        "srp": (srp.apply_to_signal, srp_cpu.apply_to_signal),
    }
    frames_cpu = frames.cpu()
    for name, (on_card, on_cpu) in fams.items():
        # warm-up: a frame of 2048 samples for the scanning families (their FFT and
        # matmul shapes but a sixth of the scan), SRP's whole frame for its plans
        on_card(frames[:1] if name == "srp" else frames[:1, :2048])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = on_card(frames)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        on_card(frames[:1])
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        prof_c = on_cpu(frames_cpu)
        prof = prof.cpu()
        if prof.shape != (B, G) or not bool(torch.isfinite(prof).all()):
            fail(f"{name}: profiles malformed {tuple(prof.shape)}")
        scale = prof_c.abs().amax(dim=-1, keepdim=True)
        err = float(((prof - prof_c).abs() / scale).max())
        if err > FAMILY_RTOL[name]:
            fail(f"{name}: the card's profiles differ from the CPU path's by {err:.3e} of the row peak "
                 f"(> {FAMILY_RTOL[name]})")
        decided = top_two_margin(prof_c) > FAMILY_RTOL[name]
        step = (prof.argmax(dim=-1) - prof_c.argmax(dim=-1)).abs().numpy()
        same = step == 0
        if not same[decided].all() or step.max() > 1:
            fail(f"{name}: DoAs differ from the CPU path's on frames {np.flatnonzero(decided & ~same).tolist()} "
                 f"whose top-two margin exceeds the tolerance, or by {step.max()} grid steps")
        est = grid[prof.argmax(dim=-1).numpy()]
        errs = folded_deg(est, doas)
        if errs.max() > FAMILY_GATE_DEG[name]:
            fail(f"{name}: folded error {errs.max():.2f} deg on frame {int(errs.argmax())} "
                 f"(gate {FAMILY_GATE_DEG[name]} deg)")
        out[name] = dict(batch_ms=batch_ms, frame_ms=batch_ms / B, one_ms=one_ms, err=err,
                         undecided=int((~decided).sum()), max_err_deg=float(errs.max()))
        print(f"[families] {name}: {B} frames, profiles = the CPU path's within {err:.2e} of the row peak "
              f"(tolerance {FAMILY_RTOL[name]}), DoAs equal on the {int(decided.sum())} frames whose top-two margin "
              f"exceeds it ({int((~decided).sum())} others, {int((~decided & ~same).sum())} of them a grid step off); "
              f"folded error at most {errs.max():.2f} deg (gate {FAMILY_GATE_DEG[name]})", flush=True)

    # the per-sample scan's share of one frame (the Hilbert and MUSIC apply paths)
    x1 = frames[:1].movedim(1, 0)  # (T, 1, M)
    h = analytic(x1, bf.kernel)
    for key, ba, x in (("hilbert_scan_ms", bf.bandpass_filter, h), ("music_scan_ms", music.filterbank.ba_list[0], x1)):
        t0 = time.perf_counter()
        iir_filter(*ba, x, method="scan")
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) * 1e3

    # ---- two sources: MUSIC's noise subspace, top-K peaks, the GNN tracker
    src2 = [(1.0, 1700.0), (-1.3, 1820.0)]
    mix = torch.as_tensor(mix_frames(torch, interp, geo, src2, 8, T, fs, seed=20, sign=-1), device=dev)
    ps = music.beamforming(mix, 2, 2048, num_sources=2)
    idx, _, ok = top_k_peaks(ps, 2, distance=max(G // 32, 2), rel_height=0.2)
    trk = MultiDoaTracker(4, max_misses=4)
    for i in range(mix.shape[0]):
        thetas, confirmed = trk.update(grid[idx[i].cpu().numpy()], ok[i].cpu().numpy())
    tracks = thetas[confirmed]
    if tracks.size != 2 or max(min(wrapped_deg(tracks, d)) for d, _ in src2) > 5.0:
        fail(f"two sources: confirmed tracks {np.rad2deg(tracks)} deg, the sources at "
             f"{[round(float(np.rad2deg(d)), 1) for d, _ in src2]} deg (gate: two, each within 5 deg)")
    print(f"[families] two sources (MUSIC, num_sources=2, 8 frames): confirmed tracks "
          f"{np.round(np.rad2deg(tracks), 2).tolist()} deg for sources at "
          f"{[round(float(np.rad2deg(d)), 2) for d, _ in src2]} deg", flush=True)

    # ---- the offline localizer on a 7-channel wav written from a seed
    import tempfile

    from scipy.io import wavfile

    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HM2024_TORCH_CACHE"] = tmp  # the xylo design and table the CLI makes stay in the temp dir
        doa_cli = 0.9
        n_cli = 3  # a track confirms on its third frame
        x = mix_frames(torch, interp, geo, [(doa_cli, 1750.0)], 1, n_cli * T, fs, seed=21, sign=1)[0]
        wav = os.path.join(tmp, "array.wav")
        wavfile.write(wav, fs, (0.5 * x / np.abs(x).max() * 32767).astype(np.int16))
        runs = [(m, "--track") for m in ("xylo", "hilbert", "music", "srp")] + \
               [(m, "--sources 2") for m in ("music", "xylo")]
        for model, opt in runs:
            argv = [wav, "--model", model, *opt.split(), "--frame", str(frame), "--grid", "225", "--device", dev.type]
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            rc, recs = run_cli(localize, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.launch_counts)
            frames_out = [r for r in recs if "frame" in r]
            key = "doa_tracked_rad" if opt == "--track" else "sources"
            if rc != 0 or len(frames_out) != n_cli or recs[-1].get("frames") != n_cli \
                    or any(not {"frame", "t_sec", "doa_rad", "doa_deg", key} <= r.keys() for r in frames_out):
                fail(f"localize {model} {opt}: rc {rc}, lines {recs}")
            errs = folded_deg([r["doa_rad"] for r in frames_out], doa_cli)
            if errs.max() > 5.0:
                fail(f"localize {model} {opt}: per-frame folded errors {np.round(errs, 2).tolist()} deg (gate 5)")
            if model == "xylo":
                for name in ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k3"):
                    if launches.get(name, 0) < n_cli:
                        fail(f"localize xylo: {name} launched {launches.get(name, 0)} times for {n_cli} frames")
            cli[f"{model} {opt}"] = dict(wall_s=wall, max_err_deg=float(errs.max()), launches=launches)
            print(f"[families] localize --model {model} {opt}: rc 0, {n_cli} frames, folded error at most "
                  f"{errs.max():.2f} deg, {wall:.2f} s with the set-up"
                  + (f"; launches {launches}" if model == "xylo" else ""), flush=True)
        # ms per frame of each model's estimator, built as the CLI builds it
        for model in ("xylo", "hilbert", "music", "srp"):
            est = localize._build_estimator(model, geo, [band], np.linspace(-np.pi, np.pi, 225), frame,
                                            float(fs), dev)
            est(x[:T] if model in ("xylo", "srp") else x[:2048])  # warm-up, as above
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est(x[T:2 * T])
            torch.cuda.synchronize()
            cli[model] = (time.perf_counter() - t0) * 1e3
        del os.environ["HM2024_TORCH_CACHE"]
    out["cli"] = cli

    # ---- one daemon round: two TCP streams of two sources each, sources=2, track=True.
    # The chunks of the JAX package's two-source serving test (tests/test_server.py:595-612):
    # equal tones of 1700 and 1850 Hz from phase 0, white noise at 20 dB from a seed per chunk.
    # At 449 DoAs the folded rate's main lobe has local maxima 20-40 deg from its peak, so the
    # picker keeps the second source 60 deg away (source_min_sep_deg; the default is 20)
    streams = {0: [(np.deg2rad(90.0), 1700.0), (np.deg2rad(-45.0), 1850.0)],
               1: [(np.deg2rad(60.0), 1700.0), (np.deg2rad(-70.0), 1850.0)]}
    n_chunks = 8  # a track confirms on its third chunk and a stale one dies after four misses
    t = torch.arange(T, dtype=torch.float64) / fs
    audio = {}
    for s, src in streams.items():
        clean = sum(interp.signal_from_template(geo, t, torch.sin(2 * np.pi * f * t), d, fs=fs) for d, f in src).numpy()
        sigma = np.sqrt((clean**2).mean() / 100.0)
        audio[s] = [(clean + sigma * np.random.default_rng(40 + 10 * s + k).standard_normal(clean.shape))
                    .astype(np.float32) for k in range(n_chunks)]
    with server.LocalizationServer(demo, max_streams=4, chunk_sec=frame, sources=2, track=True, method="peak",
                                   source_min_sep_deg=60.0) as srv:
        srv.start()
        clients = {s: server.StreamClient(srv.port, s, sources=2) for s in streams}
        _build.launch_counts.clear()
        answers = {s: [] for s in streams}
        for k in range(n_chunks):
            for s, c in clients.items():
                c.send(audio[s][k])
            for s, c in clients.items():
                rid, v = c.recv_doa(timeout=120.0)
                if rid != s or v.shape != (2,):
                    fail(f"multi-source serving: stream {s} got {rid}, {v}")
                answers[s].append(v)
        time.sleep(0.2)
        launches = dict(_build.launch_counts)
        for c in clients.values():
            c.close()
    for name in ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k4"):
        if launches.get(name, 0) < 1:
            fail(f"multi-source serving never launched {name} (launch counts {launches})")
    # the direct path: the streaming step's counts, top-K on the card, a tracker per stream
    sl = StreamingLocalizer(demo)
    state = sl.init_state(4)
    trackers = {s: MultiDoaTracker(4, max_misses=4) for s in streams}
    dist = max(int(round(60.0 / (360.0 / (G - 1)))), 1)
    for k in range(n_chunks):
        xk = np.zeros((4, T, M), np.float32)
        for s in streams:
            xk[s] = audio[s][k]
        state = sl.process_chunk(state, torch.as_tensor(xk, device=dev), return_spikes=False)
        idx, _, ok = top_k_peaks(demo.doa_scores(sl.rate(state), "peak"), 2, distance=dist, rel_height=0.2)
        z = torch.where(ok, demo._doa_t.to(torch.float32)[idx], float("nan")).cpu().numpy()
        for s in streams:
            th, cf = trackers[s].update(z[s], valid=np.isfinite(z[s]))
            want = np.full(2, np.nan, np.float32)
            want[: cf.sum()] = th[cf][:2]
            if not np.array_equal(answers[s][k], want, equal_nan=True):
                fail(f"multi-source serving: stream {s} chunk {k} answered {answers[s][k]}, the direct path {want}")
    for s, src in streams.items():
        last = answers[s][-1]
        if not np.isfinite(last).all() or max(min(folded_deg(last, d)) for d, _ in src) > 25.0:
            fail(f"multi-source serving: stream {s} ends with tracks {np.rad2deg(last)} deg, its sources at "
                 f"{[round(float(np.rad2deg(d)), 1) for d, _ in src]} deg (gate: two, each within 25 deg)")
    out["serve_launches"] = launches
    print(f"[families] serving sources=2 track=True: 2 streams x {n_chunks} chunks, every answer equal to the "
          f"direct step + top-K + tracker; final tracks "
          f"{ {s: np.round(np.rad2deg(a[-1]), 1).tolist() for s, a in answers.items()} } deg; launches {launches}",
          flush=True)
    return out


# ------------------------------------------------------------------ phase 21
# the JAX package's records (RESULTS.md:285-286, :555-562): the quantized Xylo MC on
# the 112-point grid, tone, 100 trials x 11 SNRs: the matched estimator 3.0 deg at
# -10 dB to 1.5 deg at 20 dB (1.6-3.2 deg over the sweep), the reference-parity
# peak 4-10 deg; the envelope of that peak over the four step conventions at 25
# trials: 4.5-6.1 deg at -10 dB, 3.9-9.3 at 2, 4.9-14.1 at 11, 6.7-13.8 at 20; the
# push-to-hidden energy proxy about 276 uW (RESULTS.md:581)
JAX_XYLO_RECORDS = ("matched 3.0 deg @-10 dB -> 1.5 deg @20 dB (1.6-3.2 over the sweep); reference-parity "
                    "peak 4-10 deg; its convention envelope 4.5-6.1 @-10, 3.9-9.3 @2, 4.9-14.1 @11, 6.7-13.8 "
                    "@20 dB; push-to-hidden about 276 uW")
MATCHED_MAE_GATE, REFERENCE_MAE_GATE = 4.0, 15.0  # deg at every SNR, 100 trials each
SIM_ROWS = 25  # frames through the simulator at full width: (25, 12 000, 449) int32 rasters
MC_TRIALS, ENVELOPE_TRIALS, XYLO_FRAME = 100, 25, 0.25  # target_xylo_localization's trials a SNR, frame s
SPIKE_MOVE_TOL = 1e-3  # the card's raster from audio against the CPU path's, as a fraction of the spikes


def sim_run(torch, XyloSim, cfg, spikes, ordering, reset):
    """One recorded ``XyloSim`` call on ``spikes``' device: every output,
    and its seconds (host clock, synchronized)."""
    dev = spikes.device
    sim = XyloSim(cfg, ordering=ordering, reset=reset, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, state, rec = sim(spikes, record=True, record_power=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    res = {"readout": out, **rec}
    res.update({f"state.{part}[{i}]": s for part in ("hidden", "out") for i, s in enumerate(state[part])})
    return res, sec


def equal_on_host(torch, card: dict, host: dict, label: str):
    if sorted(card) != sorted(host):
        fail(f"{label}: outputs {sorted(card)} != {sorted(host)}")
    for k, v in host.items():
        if card[k].shape != v.shape or not torch.equal(card[k].cpu(), v):
            fail(f"{label}: {k} differs between the card and the CPU path "
                 f"({mismatches(card[k], v) if card[k].shape == v.shape else 'shape'} entries)")


def check_xylo(torch, _build, Demo, flagship, demo, frames, dev):
    """Phase 21: the simulator, the stage API, push-to-hidden and the MC
    accuracy harness at full width (module docstring)."""
    import tempfile

    from haghighatshoarmuir2024_tpu_torch.experiments import target_push_to_hidden as p2h
    from haghighatshoarmuir2024_tpu_torch.experiments import target_xylo_localization as txl
    from haghighatshoarmuir2024_tpu_torch.experiments.common import FS, sinusoid_template, snr_sweep_config
    from haghighatshoarmuir2024_tpu_torch.models.xylo import DemoPushToHidden, XyloSim, estimate_power
    from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import XyloSimPushToHidden
    from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import ORDERINGS, RESETS
    from haghighatshoarmuir2024_tpu_torch.parallel import make_trial_fn

    out = {"sim": {}}
    t_phase = time.perf_counter()
    cpu_demo = Demo(**{**flagship, "device": "cpu"})  # the bundled design, on the CPU path

    # ---- (a) the simulator on the card against the CPU path, bit-exact, at full width
    spk = demo.spike_encoding(frames[:SIM_ROWS])  # (25, 12 000, 28) int32
    spk_host = spk.cpu()
    pdemo = DemoPushToHidden(**flagship)  # the bundled design, fan-out truncated
    runs = [(f"{o}/{r}, uniform w_rec", demo.xylo_config, o, r) for o in ORDERINGS for r in RESETS]
    # stage 2 with a sparse random recurrence R: the truncation zeroes the flagship's own
    n2 = pdemo.xylo.n_stage2
    rng = np.random.default_rng(SEED)
    r = (rng.integers(-3, 4, size=(n2, n2)) * (rng.random((n2, n2)) < 0.2)).astype(np.int32)
    p1 = pdemo.xylo
    psim = XyloSimPushToHidden(dataclasses.replace(pdemo.xylo_config, w_rec=r), p1.injection_weight, p1.dash_syn_in,
                               p1.dash_mem_in, p1.threshold_in, device=dev)
    runs.append(("decay_first/subtract, dense w_rec [[0, W], [0, R]]", psim.block_config(), "decay_first",
                 "subtract"))
    for label, cfg, ordering, reset in runs:
        card, card_s = sim_run(torch, XyloSim, cfg, spk, ordering, reset)
        host, host_s = sim_run(torch, XyloSim, cfg, spk_host, ordering, reset)
        equal_on_host(torch, card, host, f"XyloSim {label}")
        n_spk = int(host["Spikes"].sum())
        if n_spk == 0:
            fail(f"XyloSim {label}: no hidden spike")
        out["sim"][label] = dict(card_s=card_s, cpu_s=host_s, spikes=n_spk)
        print(f"[xylo] XyloSim {label}, record=True, (B, T, N) = {tuple(host['Spikes'].shape)}: spikes, Isyn, Vmem, "
              f"readout, synops and states == the CPU path ({n_spk} spikes); {card_s:.3f} s on the card, "
              f"{host_s:.3f} s on the CPU", flush=True)
    # the block form equals the push-to-hidden simulator's two stages at the flagship's width
    staged, _, _ = psim.evolve_to_hidden(spk)
    if not torch.equal(staged.cpu(), host["Spikes"]):
        fail("the dense block run differs from XyloSimPushToHidden's two stages on the same raster")
    print("[xylo] the dense block run == XyloSimPushToHidden.evolve_to_hidden on the same raster", flush=True)
    del card, host, staged

    # ---- (b) the stages: spike_encoding, xylo_process, the single-frame matched forward
    few = frames[:4]
    raster = demo.spike_encoding(few)
    cs = demo.encode(few)
    same_cs = cpu_demo.raster(*cpu_demo.rzcc(cs.cpu())).to(torch.int32).transpose(0, 1)  # the CPU path's RZCC
    if not torch.equal(raster.cpu(), same_cs):
        fail("spike_encoding: the card's raster differs from the CPU path's on the same cs")
    host_raster = cpu_demo.spike_encoding(few.cpu())
    moved = mismatches(raster, host_raster)
    if moved > SPIKE_MOVE_TOL * int(host_raster.sum()):
        fail(f"spike_encoding: {moved} raster entries differ from the CPU path's on the same audio")
    hidden = demo.xylo_process(raster)
    if not torch.equal(hidden.cpu(), cpu_demo.xylo_process(raster.cpu())):
        fail("xylo_process: the card's hidden raster differs from the CPU path's on the same input")
    b_doa, _ = demo.forward_batch(few, method="matched")
    frame_launches = {}
    for i in range(len(few)):
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        doa, _ = demo.forward(few[i], method="matched")
        torch.cuda.synchronize()
        frame_launches = dict(_build.launch_counts)
        if float(doa) != float(b_doa[i]):
            fail(f"Demo.forward(matched) frame {i}: DoA {float(doa)} != forward_batch(matched)'s {float(b_doa[i])}")
    for name in ("rzcc_k1", "rzcc_k2", "lif_pack_raster", "lif_k5"):
        if frame_launches.get(name, 0) < 1:
            fail(f"Demo.forward(matched) never launched {name} ({frame_launches})")
    out["frame_launches"] = frame_launches
    print(f"[xylo] stages on {len(few)} frames: spike_encoding == the CPU path on the same cs, {moved} of "
          f"{int(host_raster.sum())} spikes moved from the same audio (gate {SPIKE_MOVE_TOL:g} of them); "
          f"xylo_process == the CPU path; Demo.forward(matched) DoAs == forward_batch(matched)'s, launches a "
          f"frame {frame_launches}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        prev_cache = os.environ.get("HM2024_TORCH_CACHE")
        os.environ["HM2024_TORCH_CACHE"] = tmp  # the designs and tables made here stay in the temp dir
        try:
            # ---- (c) push-to-hidden: the reference configuration, the power workload, 8 trials
            t0 = time.perf_counter()
            pd = p2h.build_demo(16 * 7, XYLO_FRAME, device=dev)  # designed on the card
            torch.cuda.synchronize()
            out["p2h_design_s"] = time.perf_counter() - t0
            pd_host = p2h.build_demo(16 * 7, XYLO_FRAME, device="cpu")  # the card's design, from the cache
            for name in ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "threshold"):
                if not np.array_equal(getattr(pd.xylo_config, name), getattr(pd_host.xylo_config, name)):
                    fail(f"push-to-hidden: the CPU twin's {name} differs")
            s_in, full = p2h.power_workload(pd)
            h_in, h_full = p2h.power_workload(pd_host)
            if not torch.equal(s_in.cpu(), h_in) or not torch.equal(full.cpu(), h_full):
                fail("push-to-hidden power workload: the card's rasters differ from the CPU path's")
            power = p2h.power_measurement(pd)
            if power != p2h.power_measurement(pd_host):
                fail("push-to-hidden: estimate_power on the card differs from the CPU path's")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loc = p2h.localization_check(pd, num_trials=8)
            out["p2h_check_s"] = time.perf_counter() - t0
            out["p2h_power_uW"], out["p2h_mae_deg"] = power["power_avg_uW"], loc["mae_deg"]
            print(f"[xylo] push-to-hidden (1600-1900 Hz, grid 112, {XYLO_FRAME} s, bipolar, hardware constraints): design "
                  f"on the card {out['p2h_design_s']:.3f} s; w_rec nonzeros "
                  f"{int(np.count_nonzero(pd.xylo_config.w_rec))}; power workload (2 ms of 1 kHz spikes, seed 0) "
                  f"rasters and estimate_power == the CPU path: {power['power_avg_uW']:.3f} uW, synops "
                  f"{power['synops_total']:.0f}; localization check, 8 trials at 10 dB: MAE {loc['mae_deg']:.3f} deg "
                  f"({out['p2h_check_s']:.3f} s)", flush=True)

            # ---- (d) the MC accuracy harness at full size: 1000-2000 Hz, grid 112, 100 x 11, bipolar
            t0 = time.perf_counter()
            td = txl.build_demo(True, 16 * 7, XYLO_FRAME, device=dev)  # designed on the card
            torch.cuda.synchronize()
            out["mc_design_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = txl.run(demo=td, num_sims=MC_TRIALS, envelope=False, duration=XYLO_FRAME)
            torch.cuda.synchronize()
            out["mc_s"] = time.perf_counter() - t0
            t, sig = sinusoid_template(1500.0, XYLO_FRAME)
            t0 = time.perf_counter()
            env = txl.convention_envelope(td, t, sig, snr_sweep_config(), num_sims=ENVELOPE_TRIALS)
            torch.cuda.synchronize()
            out["envelope_s"] = time.perf_counter() - t0
            ref_mae = np.rad2deg(res["reference_estimator"]["mae"])
            mat_mae = np.rad2deg(res["matched_estimator"]["mae"])
            out.update(ref_mae=ref_mae, matched_mae=mat_mae, env=env)
            snrs = res["matched_estimator"]["snr_db"]
            print(f"[xylo] MC (target_xylo_localization.run: 1000-2000 Hz, grid 112, {MC_TRIALS} trials x 11 SNRs, "
                  f"bipolar, tone, {XYLO_FRAME} s): design on the card {out['mc_design_s']:.3f} s, both sweeps and the "
                  f"calibration {out['mc_s']:.3f} s, the convention envelope ({ENVELOPE_TRIALS} trials x 11 SNRs x 4 "
                  f"conventions) {out['envelope_s']:.3f} s", flush=True)
            for i, snr in enumerate(snrs):
                print(f"[xylo]   {snr:+5.1f} dB: matched MAE {mat_mae[i]:.3f} deg (gate {MATCHED_MAE_GATE}), reference "
                      f"peak {ref_mae[i]:.3f} deg (gate {REFERENCE_MAE_GATE}), envelope {env['mae_deg_min'][i]:.3f}-"
                      f"{env['mae_deg_max'][i]:.3f} deg")
            print(f"[xylo] the JAX package's records: {JAX_XYLO_RECORDS}", flush=True)
            if not np.all(mat_mae <= MATCHED_MAE_GATE) or not np.all(ref_mae <= REFERENCE_MAE_GATE):
                fail(f"MC accuracy gate: matched MAE {np.round(mat_mae, 3).tolist()}, reference "
                     f"{np.round(ref_mae, 3).tolist()} deg")

            # one batch of the sweep's 100 trials at 0 dB on the card and on the CPU path, the same DoAs
            # and noise: equal DoAs, and equal counts from the card's cs
            td_host = txl.build_demo(True, 16 * 7, XYLO_FRAME, device="cpu")  # the card's design, from the cache
            td_host.calibrate_profiles(template=(t, sig))  # the card's table, from the cache
            gen = torch.Generator(device=dev).manual_seed(SEED)
            doa = 2 * np.pi * torch.rand(MC_TRIALS, generator=gen, device=dev)
            noise = torch.randn((MC_TRIALS, len(t), len(td.geometry)), generator=gen, device=dev)
            estimators = {
                "reference": lambda d: (lambda f: txl.reference_doa(d, d.fold(d.rates_batch(f)))),
                "matched": lambda d: (lambda f: d.forward_batch(f, method="matched")[0]),
            }
            out["mc_launches"] = {}
            seen = {}

            def keep_frames(fn):
                def estimate(f):
                    seen["frames"] = f
                    return fn(f)
                return estimate

            for name, est in estimators.items():
                card_trial = make_trial_fn(td.geometry, t, sig, keep_frames(est(td)), FS, device=dev)
                host_trial = make_trial_fn(td.geometry, t, sig, est(td_host), FS, device="cpu")
                torch.cuda.synchronize()
                _build.launch_counts.clear()
                _, card_est = card_trial(None, 0.0, MC_TRIALS, doa_true=doa, noise=noise)
                torch.cuda.synchronize()
                out["mc_launches"][name] = dict(_build.launch_counts)
                _, host_est = host_trial(None, 0.0, MC_TRIALS, doa_true=doa.cpu(), noise=noise.cpu())
                if not torch.equal(card_est.cpu(), host_est):
                    diff = int((card_est.cpu() != host_est).sum())
                    fail(f"MC batch ({name}): {diff} of {MC_TRIALS} DoAs differ between the card and the CPU path")
                for k in ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k3"):
                    if out["mc_launches"][name].get(k, 0) < 1:
                        fail(f"MC batch ({name}) never launched {k} ({out['mc_launches'][name]})")
            tw = twin_counts(torch, "MC batch", td, td_host, seen["frames"])
            (B_mc, _, _, N_mc), n_mc = tw.shape, int(tw.host_counts.sum())
            print(f"[xylo] one batch of {MC_TRIALS} trials at 0 dB: the card's DoAs == the CPU path's, both estimators; "
                  f"counts (B, N) = {(B_mc, N_mc)} from the card's cs == the plain path's, count by count "
                  f"({n_mc} spikes); launches a batch {out['mc_launches']}", flush=True)
        finally:
            if prev_cache is None:
                del os.environ["HM2024_TORCH_CACHE"]
            else:
                os.environ["HM2024_TORCH_CACHE"] = prev_cache
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------ main


# ------------------------------------------------------------------ phase 22
# Every accuracy gate of phase 22 is what the JAX package's own harness prints
# today at the same configuration on the CPU (its own draws), the card within one
# step of the harness's grid of it, above or below:
#   python tests/test_torch_accuracy_harnesses.py --jax-sweeps  (MAE deg at -10 and 20 dB)
#   python tests/test_torch_array_harnesses.py --full moving_target --full multi_target_tracking \
#       --full mismatch_robustness --full multiple_targets
JAX_SWEEPS = {"hilbert": (0.723, 0.419), "music": (0.768, 0.419), "snn": (6.369, 0.493), "srp tone": (3.069, 0.476),
              "srp chirp": (0.683, 0.424)}
GRID_STEP_224, GRID_STEP_112 = 360.0 / 223, 360.0 / 111
HARNESS_GRID, SWEEP_TRIALS, SPEECH_TRIALS, SWEEP_FRAME = 224, 100, 20, 0.25
SPEECH_SEC = 1.0
SPEECH_SNRS = (-10.0, 5.0, 20.0)  # on the card: with all 11 SNRs phase 22 took over 150 s (the CLI runs all 11)
# the card's profiles against the CPU path's on the same input and design, as a
# fraction of each row's peak: phase 20's for the classical families on the same
# frames; the SNN's on the same spikes, the card's RZCC raster (its float32 cumsum
# may round a near tie the other way, so a spike may move a sample from the same
# frames: counted, within phase 21's SPIKE_MOVE_TOL of the spikes)
SWEEP_RTOL = {"hilbert": 1e-3, "music": 1e-4, "srp tone": 5e-4, "srp chirp": 5e-4, "snn": 1e-5}
RES_GRID, RES_DESIGN_TOL = 112, 1e-4
SHARE_REPS = 3  # the least of three batches, its scans timed inside it
MOVING = dict(duration=4.0, frame=0.25)
JAX_MOVING = {"hilbert": 0.370, "xylo": 8.929}  # median deg
TRACKING = dict(duration=6.0, frame=0.25)
JAX_TRACKED = (0.349, 0.814)  # deg, each target's tracked MAE
# deg: hilbert_ir and music_ns2 within 5 of +-60 (RESULTS.md:291, 516-519), and
# every row's detections within a grid step of JAX's (the same numpy mixtures)
MULTI_TARGET_GATE = 5.0
JAX_DETECTED = {"hilbert": (-50.852, 50.852), "hilbert_ir": (-62.152, 62.152), "music": (-54.081, 46.009),
                "music_ns2": (-60.538, 60.538), "snn": (-54.081, 54.081)}
MISMATCH_TRIALS = 20
JAX_MISMATCH = {  # 20 trials, 10 dB, 112-point grid
    "gain": {"hilbert_mae_deg": [0.85, 0.85, 0.86, 0.86], "xylo_matched_mae_deg": [0.84, 0.84, 0.84, 0.84]},
    "pos": {"hilbert_mae_deg": [0.85, 0.94, 1.25, 2.96], "xylo_matched_mae_deg": [0.84, 1.02, 1.61, 2.78]},
}


def synced(torch, dev, fn):
    """``fn()`` and its host seconds, the card synchronized on both sides."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_sweep_batch(torch, name, card_profile, cpu_profile, inputs, rtol):
    """One 0 dB batch through the card's and the CPU path's profile on the
    same inputs: rows within ``rtol`` of their peak, DoAs equal where the
    CPU row's top-two margin exceeds it and within a grid step elsewhere."""
    prof = card_profile(inputs).cpu()
    prof_c = cpu_profile(inputs.cpu())
    scale = prof_c.abs().amax(dim=-1, keepdim=True)
    err = float(((prof - prof_c).abs() / scale).max())
    decided = top_two_margin(prof_c) > rtol
    step = (prof.argmax(dim=-1) - prof_c.argmax(dim=-1)).abs().numpy()
    step = np.minimum(step, prof.shape[-1] - 1 - step)  # rows 0 and G-1 are one direction
    if err > rtol or not (step[decided] == 0).all() or step.max() > 1:
        fail(f"{name}: the card's 0 dB batch differs from the CPU path's by {err:.3e} of the row peak (tolerance "
             f"{rtol}), DoAs on {int((step[decided] != 0).sum())} decided frames, at most {step.max()} grid steps")
    return err, int((~decided).sum())


def within_step(got, want, step) -> bool:
    """Every entry of ``got`` within one grid ``step`` of ``want``'s, above or
    below (the half-thousandth of a degree covers JAX's printed rounding)."""
    return bool(np.all(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) <= step + 5e-4))


def snn_spikes(snn, frames):
    """(B, T, M) frames → the SNN's RZCC raster (T, B, 2M) on their device:
    ``apply_to_signal``'s analytic stack, bandpass and encoder."""
    from haghighatshoarmuir2024_tpu_torch.ops.spikes import rzcc_encode

    stack = snn._bandpass(snn._analytic(frames.movedim(1, 0)))
    return rzcc_encode(stack.movedim(0, -2), snn.robust_width, snn.bipolar_spikes).movedim(-2, 0)


def snn_profile_of_spikes(torch, snn, bf_mat):
    """The rest of ``apply_to_signal`` and the sweep's profile: an RZCC
    raster (T, B, 2M) → (B, G) mean squared membrane after beamforming."""
    from haghighatshoarmuir2024_tpu_torch.ops.fir import full_fp32
    from haghighatshoarmuir2024_tpu_torch.ops.lif import lif_filter

    def profile(spikes):
        vmem = lif_filter(spikes, snn._neuron_ir(spikes.shape[0]))
        full_fp32()
        return (torch.matmul(vmem, bf_mat.to(spikes.device)) ** 2).mean(dim=0)
    return profile


def scans_inside(torch, dev, fn, modules):
    """``fn()``'s host seconds and the host seconds of the per-sample scans
    it runs inside that call: each ``(module, name)`` is wrapped for the call
    so that every call of it is timed, the card synchronized on both sides."""
    spent = []

    def timed(orig):
        def call(*args, **kwargs):
            out, sec = synced(torch, dev, lambda: orig(*args, **kwargs))
            spent.append(sec)
            return out
        return call

    saved = [(m, n, getattr(m, n)) for m, n in modules]
    for m, n, orig in saved:
        setattr(m, n, timed(orig))
    try:
        _, total = synced(torch, dev, fn)
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)
    return total, sum(spent)


def same_xylo_design(card, host, label):
    for name in ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "threshold"):
        if not np.array_equal(getattr(card.xylo_config, name), getattr(host.xylo_config, name)):
            fail(f"{label}: the CPU twin's {name} differs from the card's design")


def check_harnesses(torch, _build, dev):
    """Phase 22: the paper's accuracy, beam-pattern, multi-target and
    robustness harnesses of the classical families and the float SNN at
    the JAX harnesses' sizes (module docstring)."""
    import tempfile

    from haghighatshoarmuir2024_tpu_torch.experiments import array_resolution as ar
    from haghighatshoarmuir2024_tpu_torch.experiments import array_resolution_music as arm
    from haghighatshoarmuir2024_tpu_torch.experiments import array_resolution_snn as ars
    from haghighatshoarmuir2024_tpu_torch.experiments import common
    from haghighatshoarmuir2024_tpu_torch.experiments import mismatch_robustness as mm
    from haghighatshoarmuir2024_tpu_torch.experiments import moving_target as mt
    from haghighatshoarmuir2024_tpu_torch.experiments import multi_target_tracking as mtt
    from haghighatshoarmuir2024_tpu_torch.experiments import multiple_targets as mtg
    from haghighatshoarmuir2024_tpu_torch.experiments import srp_phat_baseline as srp_h
    from haghighatshoarmuir2024_tpu_torch.experiments import target_localization as hil_h
    from haghighatshoarmuir2024_tpu_torch.experiments import target_localization_music as mus_h
    from haghighatshoarmuir2024_tpu_torch.experiments import target_snn_localization as snn_h
    from haghighatshoarmuir2024_tpu_torch.models import beamformer as beamformer_mod
    from haghighatshoarmuir2024_tpu_torch.models import music as music_mod
    from haghighatshoarmuir2024_tpu_torch.models import snn_beamformer as snn_mod
    from haghighatshoarmuir2024_tpu_torch.models.beamformer import Beamformer
    from haghighatshoarmuir2024_tpu_torch.models.snn_beamformer import SNNBeamformer
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel
    from haghighatshoarmuir2024_tpu_torch.parallel import make_trial_fn, snr_with_bandwidth_correction

    cpu = torch.device("cpu")
    out = {"s": {}, "scan_share": {}}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    user_cache = os.environ.get("HM2024_TORCH_CACHE")
    os.environ["HM2024_TORCH_CACHE"] = tmp.name  # the designs the harnesses make stay in the temp dir
    G, F = HARNESS_GRID, SWEEP_FRAME
    T = int(round(F * common.FS))

    # ---- the four MC sweeps, tone: the card's models, their CPU twins on the same designs
    hil, hil_s = synced(torch, dev, lambda: hil_h.build(G, F, dev))
    mus = mus_h.build(G, F, dev)
    snn, snn_s = synced(torch, dev, lambda: snn_h.build(G, F, device=dev))
    hil_cpu = Beamformer(hil[0].geometry, 10e-3, hil_h.FREQ_RANGE, fs=common.FS, device=cpu)
    snn_cpu = SNNBeamformer(snn[0].geometry, 10e-3, snn_h.FREQ_RANGE, snn[0].tau_vec, bipolar_spikes=True,
                            fs=common.FS, device=cpu)
    t_chirp, _ = common.chirp_template(snn_h.FREQ_RANGE, F)
    srp_models = {t: srp_h.build(t, G, F, device=dev)[0] for t in ("tone", "chirp")}
    # name: (the sweep, a batch's profile on the card, the profiles compared on the card and on the CPU
    # path, the synthesis's delay sign)
    fams = {
        "hilbert": (lambda n: hil_h.run("tone", n, model=hil), hil_h.profile_fn(*hil[:2]), None,
                    hil_h.profile_fn(hil_cpu, hil[1].cpu()), 1),
        "music": (lambda n: mus_h.run("tone", n, model=mus), mus_h.profile_fn(mus), None,
                  mus_h.profile_fn(mus_h.build(G, F, cpu)), -1),
        "snn": (lambda n: snn_h.run("tone", n, model=snn), snn_h.profile_fn(snn[0], snn[1], t_chirp),
                snn_profile_of_spikes(torch, snn[0], snn[1]), snn_profile_of_spikes(torch, snn_cpu, snn[1].cpu()), 1),
    }
    for t in ("tone", "chirp"):
        fams[f"srp {t}"] = (lambda n, t=t: srp_h.run(t, n, G, device=dev), srp_models[t].apply_to_signal, None,
                            srp_h.build(t, G, F, device=cpu)[0].apply_to_signal, -1)
    tpl = {"hilbert": common.sinusoid_template(hil_h.TONE, F), "music": common.sinusoid_template(hil_h.TONE, F),
           "snn": common.chirp_template(snn_h.FREQ_RANGE, F), "srp tone": common.sinusoid_template(1750.0, F),
           "srp chirp": common.chirp_template((1600.0, 2600.0), F)}
    out["sweeps"] = {}
    rng = np.random.default_rng(SEED + 22)
    doas0 = rng.uniform(0, 2 * np.pi, SWEEP_TRIALS).astype(np.float32)
    noise0 = rng.standard_normal((SWEEP_TRIALS, T, 7)).astype(np.float32)
    # the per-sample scans of the Hilbert, MUSIC and SNN apply paths, timed inside their batch
    scans = {"hilbert": [(beamformer_mod, "iir_filter")], "music": [(music_mod, "iir_filter")],
             "snn": [(snn_mod, "iir_scan")]}
    for name, (sweep, on_card, card_cmp, cpu_cmp, sign) in fams.items():
        on_card(torch.as_tensor(noise0[:1, :2048], device=dev))  # warm-up: plans, allocator
        res, sec = synced(torch, dev, lambda: sweep(SWEEP_TRIALS))
        mae = np.rad2deg(res["mae"])
        want = JAX_SWEEPS[name]
        if not np.isfinite(mae).all() or not within_step(mae[[0, -1]], want, GRID_STEP_224):
            fail(f"{name} sweep: MAE {np.round(mae, 3).tolist()} deg; at -10 and 20 dB within {GRID_STEP_224:.2f} "
                 f"(one grid step) of JAX's harness's {want}")
        # one batch at 0 dB (the SNN's bandwidth-corrected) on the same DoAs and noise, card and CPU
        snr0 = snr_with_bandwidth_correction(0.0, common.FS, snn_h.FREQ_RANGE) if name == "snn" else 0.0
        frames0 = make_trial_fn(hil[0].geometry, *tpl[name], lambda f: f, common.FS, delay_sign=sign,
                                device=dev)(None, snr0, SWEEP_TRIALS, doa_true=doas0, noise=noise0)[1]
        inputs, moved = frames0, ""
        if name == "snn":  # the card's spikes go to both paths; the CPU's own spikes of the same frames are counted
            inputs = snn_spikes(snn[0], frames0)
            host_spikes = snn_spikes(snn_cpu, frames0.cpu())
            n_moved = mismatches(inputs, host_spikes)
            if n_moved > SPIKE_MOVE_TOL * int(host_spikes.abs().sum()):
                fail(f"snn: {n_moved} RZCC entries of the 0 dB batch differ between the card and the CPU path on "
                     f"the same frames ({int(host_spikes.abs().sum())} spikes)")
            moved = f"; from the same frames {n_moved} of {int(host_spikes.abs().sum())} spikes moved"
            del host_spikes
        (err, undecided), cpu_s = synced(torch, dev, lambda: check_sweep_batch(torch, name, card_cmp or on_card,
                                                                              cpu_cmp, inputs, SWEEP_RTOL[name]))
        runs = [scans_inside(torch, dev, lambda: on_card(frames0), scans.get(name, [])) for _ in range(SHARE_REPS)]
        batch_s, scan_s = min(runs)
        out["sweeps"][name] = dict(mae=mae.tolist(), s=sec, batch_s=batch_s, err=err, undecided=undecided,
                                   cpu_s=cpu_s)
        if name in scans:
            out["scan_share"][name] = (scan_s, batch_s)
        print(f"[harness] {sweep_label(name)} sweep ({SWEEP_TRIALS} x 11, grid {G}): MAE deg "
              f"{np.round(mae, 3).tolist()} (JAX's harness {want[0]} @-10 -> {want[1]} @20 dB; gate +- "
              f"{GRID_STEP_224:.2f}); {sec:.2f} s; the 0 dB batch = the CPU path's on the same "
              f"{'spikes' if name == 'snn' else 'frames'} within {err:.2e} of the row peak (tolerance "
              f"{SWEEP_RTOL[name]}; {undecided} frames under it, a grid step allowed){moved}", flush=True)
        del inputs

    # ---- speech, on whatever speech_template finds: gated finite
    t_sp, s_sp = common.speech_template(duration=SPEECH_SEC)
    snrs = np.asarray(SPEECH_SNRS)
    speech = {
        "hilbert": lambda: common.mc_sweep(hil_h.profile_fn(*hil[:2]), hil[2], hil[0].geometry, t_sp, s_sp,
                                           SPEECH_TRIALS, 0, dev, snr_db_vec=snrs),
        "music": lambda: common.mc_sweep(mus_h.profile_fn(mus), mus.doa_list, mus.geometry, t_sp, s_sp, SPEECH_TRIALS,
                                         0, dev, snr_db_vec=snrs, delay_sign=-1),
        "snn": lambda: common.mc_sweep(snn_h.profile_fn(snn[0], snn[1], t_sp), snn[2], snn[0].geometry, t_sp, s_sp,
                                       SPEECH_TRIALS, 0, dev, snr_db_vec=[
                                           snr_with_bandwidth_correction(s, common.FS, snn_h.FREQ_RANGE)
                                           for s in snrs]),
        "srp": lambda: common.mc_sweep(*speech_srp(srp_h, G, dev), SPEECH_TRIALS, 0, dev, snr_db_vec=snrs,
                                       delay_sign=-1),
    }
    out["speech"] = {}
    for name, fn in speech.items():
        res, sec = synced(torch, dev, fn)
        mae = np.rad2deg(res["mae"])
        if not np.isfinite(mae).all():
            fail(f"{name} speech sweep: MAE {mae}")
        out["speech"][name] = dict(mae=mae.tolist(), s=sec)
        print(f"[harness] {name} speech sweep ({SPEECH_TRIALS} trials at {np.round(snrs, 1).tolist()} dB, "
              f"{len(t_sp) / common.FS:.2f} s of {'the LibriSpeech sample' if os.path.exists(common.SPEECH_FLAC) else 'the synthetic fallback'}): "
              f"MAE deg {np.round(mae, 3).tolist()}; {sec:.2f} s", flush=True)

    # ---- the three array-resolution harnesses: designs on the card = the CPU path's up to a unit phase
    res_grid = np.linspace(-np.pi, np.pi, RES_GRID)
    worst = 1.0
    t0 = time.perf_counter()
    for kind in ("sin", "noise"):
        for f in ar.FREQS:
            card_bf = ar.design(f, kind, res_grid, device=dev).cpu().numpy()
            cos = min_unit_phase_cos(card_bf, ar.design(f, kind, res_grid, device=cpu).numpy())
            worst = min(worst, cos)
            if cos < 1 - RES_DESIGN_TOL:
                fail(f"array_resolution {kind} {f:.0f} Hz: the card's design is off the CPU path's: 1 - {1 - cos:.3e}")
    widths_hil = {kind: ar.run(kind, RES_GRID, device=dev) for kind in ("sin", "noise")}
    out["s"]["array_resolution"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    widths_snn = {}
    for kind in ars.KINDS:
        geo, grid = ars.build_geometry(kind, RES_GRID)
        card_bf = ars.design(geo, grid, 2_000.0, device=dev).cpu().numpy()
        cos = min_unit_phase_cos(card_bf, ars.design(geo, grid, 2_000.0, device=cpu).numpy(), fold=True)
        worst = min(worst, cos)
        if cos < 1 - RES_DESIGN_TOL:
            fail(f"array_resolution_snn {kind} 2 kHz: the card's design is off the CPU path's: 1 - {1 - cos:.3e}")
        widths_snn[kind] = ars.run(kind, num_grid=RES_GRID, device=dev)
    out["s"]["array_resolution_snn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    widths_mus = {kind: arm.run(kind, num_grid=RES_GRID, device=dev) for kind in ars.KINDS}
    out["s"]["array_resolution_music"] = time.perf_counter() - t0
    for kind in ars.KINDS:
        for f, entry in widths_mus[kind].items():
            if not all(np.isfinite(list(e.values())).all() for e in entry.values()):
                fail(f"array_resolution_music {kind} {f}: {entry}")
    print(f"[harness] array resolution: every Hilbert design (5 frequencies x 2 templates) and the SNN's at 2 kHz on "
          f"each array = the CPU path's per column up to a unit phase, worst 1 - {1 - worst:.3e} (gate "
          f"{RES_DESIGN_TOL}); -3 dB widths (mean/max deg) Hilbert "
          + "; ".join(f"{k}: " + ", ".join(f"{f} {v['beamwidth_3db_deg_mean']:.1f}/{v['beamwidth_3db_deg_max']:.1f}"
                                           for f, v in w.items()) for k, w in widths_hil.items())
          + "; SNN " + "; ".join(f"{k}: " + ", ".join(f"{f} {v['beamwidth_3db_deg_mean']:.1f}/"
                                                       f"{v['beamwidth_3db_deg_max']:.1f}" for f, v in w.items())
                                 for k, w in widths_snn.items())
          + "; MUSIC at 20 dB (doa_0 width deg / peak error deg) "
          + "; ".join(f"{k}: " + ", ".join(f"{f} {v['doa_0']['beamwidth_3db_deg']:.1f}/{v['doa_0']['peak_err_deg']:.2f}"
                                           for f, v in w.items()) for k, w in widths_mus.items()), flush=True)

    # ---- multiple_targets
    mtg_res, out["s"]["multiple_targets"] = synced(torch, dev, lambda: mtg.run(device=dev))
    for name in ("hilbert_ir", "music_ns2"):
        det = np.asarray(mtg_res[name]["detected_deg"])
        if det.size != 2 or np.abs(np.sort(det) - np.array([-60.0, 60.0])).max() > MULTI_TARGET_GATE:
            fail(f"multiple_targets {name}: detected {det} deg (gate: each within {MULTI_TARGET_GATE} of -60/+60)")
    for name, want in JAX_DETECTED.items():
        det = np.sort(mtg_res[name]["detected_deg"])
        if det.size != 2 or not within_step(det, want, GRID_STEP_224):
            fail(f"multiple_targets {name}: detected {det} deg, JAX's harness {want} (gate: one grid step)")
    print(f"[harness] multiple_targets (224-point grid, 20 dB): "
          + ", ".join(f"{k} {np.round(v['detected_deg'], 1).tolist()}" for k, v in mtg_res.items()
                      if k != "targets_deg") + f" deg (JAX's harness {JAX_DETECTED}; gate: one grid step)", flush=True)

    # ---- moving_target: Hilbert as one batch, Xylo one Demo.forward a frame
    n_frames = int(MOVING["duration"] / MOVING["frame"])
    demo_mt = mt.build_demo(G, MOVING["frame"], dev)  # designed on the card (warm-up of the harness's own)
    _build.launch_counts.clear()
    mt_res, out["s"]["moving_target"] = synced(torch, dev, lambda: mt.run(MOVING["duration"], 10.0, MOVING["frame"],
                                                                          G, dev, demo=demo_mt))
    mt_launches = dict(_build.launch_counts)
    for name in ("rzcc_k1", "lif_pack_raster", "lif_k5"):
        if mt_launches.get(name, 0) != n_frames:
            fail(f"moving_target: {name} launched {mt_launches.get(name, 0)} times for {n_frames} frames")
    if mt_launches.get("rzcc_k2", 0) < n_frames:
        fail(f"moving_target: rzcc_k2 launched {mt_launches.get('rzcc_k2', 0)} times for {n_frames} frames")
    for name, want in JAX_MOVING.items():
        if not within_step(mt_res[name]["median_err_deg"], want, GRID_STEP_224):
            fail(f"moving_target {name}: median error {mt_res[name]['median_err_deg']:.3f} deg, JAX's harness "
                 f"{want} (gate: one grid step, {GRID_STEP_224:.2f})")
    out["moving_launches"] = mt_launches
    # the same frames through the CPU path's Demo.forward on the card's design (from the cache): equal
    # DoAs; and K1 -> K2 -> raster pack -> K5 at B = 1 on the card's cs of each frame = the plain path's
    # counts, count by count
    t0 = time.perf_counter()
    demo_mt_cpu = mt.build_demo(G, MOVING["frame"], cpu)
    same_xylo_design(demo_mt, demo_mt_cpu, "moving_target")
    frames_mt = mt.split_frames(mt.scene(MOVING["duration"], 10.0, MOVING["frame"], dev)[0], n_frames, MOVING["frame"])
    doa_card = np.array([float(demo_mt.forward(f)[0]) for f in frames_mt])
    doa_host = np.array([float(demo_mt_cpu.forward(f)[0]) for f in frames_mt.cpu()])
    if not np.array_equal(doa_card, doa_host):
        fail(f"moving_target: the card's Xylo DoAs differ from the CPU path's on frames "
             f"{np.flatnonzero(doa_card != doa_host).tolist()} of {n_frames}")
    cs_mt = [demo_mt.encode(f[None]) for f in frames_mt]  # (T, 1, C) each
    card_counts = torch.cat([lif_kernel.lif_count_rates(demo_mt.lif_params(), demo_mt.raster(*demo_mt.rzcc(cs)),
                                                        time_major=True, spike_bound=1) for cs in cs_mt]).cpu()
    cs_host = torch.cat(cs_mt, dim=1).cpu()
    host_counts = lif_kernel.lif_count_rates(demo_mt_cpu.lif_params(), demo_mt_cpu.raster(*demo_mt_cpu.rzcc(cs_host)),
                                             time_major=True, spike_bound=1)
    if card_counts.shape != host_counts.shape or not torch.equal(card_counts, host_counts):
        fail(f"moving_target: K5's counts {tuple(card_counts.shape)} from the card's cs differ from the plain path's "
             f"({mismatches(card_counts, host_counts) if card_counts.shape == host_counts.shape else 'shape'} entries)")
    out["s"]["moving_target_cpu_check"] = time.perf_counter() - t0
    print(f"[harness] moving_target ({n_frames} frames): "
          + ", ".join(f"{k} median {v['median_err_deg']:.3f} / mean {v['mae_deg']:.3f} deg" for k, v in mt_res.items())
          + f" (JAX's harness: Hilbert {JAX_MOVING['hilbert']}, Xylo {JAX_MOVING['xylo']}; gate +- "
          f"{GRID_STEP_224:.2f}); launches {mt_launches}; the Xylo DoAs == the CPU path's Demo.forward, frame by "
          f"frame; counts (B, N) = {tuple(host_counts.shape)} from the card's cs through K1 -> K2 -> raster pack -> "
          f"K5 at B = 1 == the plain path's, count by count ({int(host_counts.sum())} spikes)", flush=True)

    # ---- multi_target_tracking
    mtt_res, out["s"]["multi_target_tracking"] = synced(torch, dev, lambda: mtt.run(TRACKING["duration"], 10.0,
                                                                                     TRACKING["frame"], G, dev))
    if not mtt_res["identity_held"] or not within_step(mtt_res["tracked_mae_deg"], JAX_TRACKED, GRID_STEP_224):
        fail(f"multi_target_tracking: {mtt_res} (JAX's harness: tracked MAE {JAX_TRACKED}; gate: one grid step)")
    print(f"[harness] multi_target_tracking ({mtt_res['n_frames']} frames): identity held, tracked MAE "
          f"{np.round(mtt_res['tracked_mae_deg'], 3).tolist()} deg (JAX's harness {list(JAX_TRACKED)}; gate +- "
          f"{GRID_STEP_224:.2f}), max "
          f"{np.round(mtt_res['tracked_max_err_deg'], 3).tolist()}, sorted-peaks baseline "
          f"{np.round(mtt_res['sorted_peaks_baseline_mae_deg'], 3).tolist()}, {mtt_res['confirmed_final']} tracks "
          "confirmed at the end", flush=True)

    # ---- mismatch_robustness: one Hilbert batch and one rates_batch (K1, K2, pack, K3) a value
    model, build_s = synced(torch, dev, lambda: mm.build(RES_GRID, device=dev))
    _build.launch_counts.clear()
    mm_res, out["s"]["mismatch_robustness"] = synced(torch, dev, lambda: mm.run(MISMATCH_TRIALS, RES_GRID,
                                                                                device=dev, model=model))
    mm_launches = dict(_build.launch_counts)
    n_batches = len(mm.GAIN_DB) + len(mm.POS_MM)
    for name in ("rzcc_k1", "lif_pack", "lif_k3"):
        if mm_launches.get(name, 0) != n_batches:
            fail(f"mismatch_robustness: {name} launched {mm_launches.get(name, 0)} times for {n_batches} batches")
    if mm_launches.get("rzcc_k2", 0) < n_batches:
        fail(f"mismatch_robustness: rzcc_k2 launched {mm_launches.get('rzcc_k2', 0)} times for {n_batches} batches")
    for kind, rows in JAX_MISMATCH.items():
        for key, want in rows.items():
            if not within_step(mm_res[kind][key], want, GRID_STEP_112):
                fail(f"mismatch_robustness {kind} {key}: {mm_res[kind][key]} deg, JAX's harness {want} "
                     f"(gate: one grid step, {GRID_STEP_112:.2f})")
    out["mismatch_launches"] = mm_launches
    # every batch again on the CPU path's model (the card's design and table, from the cache): equal
    # matched DoAs from the same frames, and K1 -> K2 -> pack -> K3 on the card's cs = the plain path's counts
    t0 = time.perf_counter()
    demo_mm, demo_mm_cpu = model[2], mm.build_demo(RES_GRID, device=cpu)
    n_spikes = 0
    for kind, values in (("gain", mm.GAIN_DB), ("pos", mm.POS_MM)):
        for v in values:
            frames_mm, _ = mm.trial_frames(kind, v, MISMATCH_TRIALS, device=dev)
            n_spikes += xylo_twin(torch, f"mismatch_robustness {kind} {v}", demo_mm, demo_mm_cpu, frames_mm,
                                  "matched")[1]
    out["s"]["mismatch_cpu_check"] = time.perf_counter() - t0
    print(f"[harness] mismatch_robustness ({MISMATCH_TRIALS} trials, 112-point grid, 10 dB): gain "
          f"{mm_res['gain']}, position {mm_res['pos']} (JAX's harness {JAX_MISMATCH}; gate +- {GRID_STEP_112:.2f}); "
          f"launches {mm_launches} for {n_batches} batches; model {build_s:.2f} s; every batch's matched DoAs == "
          f"the CPU path's, and its counts (B, N) = ({MISMATCH_TRIALS}, {RES_GRID}) from the card's cs through K1 -> "
          f"K2 -> pack -> K3 == the plain path's, count by count ({n_spikes} spikes)", flush=True)

    out["s"].update({"hilbert_design": hil_s, "snn_design": snn_s})
    if user_cache is None:
        del os.environ["HM2024_TORCH_CACHE"]
    else:
        os.environ["HM2024_TORCH_CACHE"] = user_cache
    tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------ phase 23
# Every accuracy gate of phase 23 is what the JAX package's own harness prints today at the same
# configuration on the CPU (JAX_PLATFORMS=cpu HM2024_JAX_CACHE=0 python experiments/<name>.py ...), the
# card within one step of the harness's grid of it, above or below:
#   reduced_rate.py and reduced_rate.py --band=hi (25 trials at 0 and 10 dB, 113 points): MAE deg
JAX_REDUCED = {
    "lo": {48_000: ([0.7846017937054119, 0.9003846410192236], [11.266197866960187, 14.17211555853007]),
           24_000: ([1.0058499517350494, 0.8712143535131799], [10.91668419466167, 14.257625711688652]),
           12_000: ([2.0608100976570234, 1.5079619356534488], [23.714850634729892, 29.388171688824983])},
    "hi": {48_000: ([0.8432843524321406, 0.8874300485893591], [6.020635106248151, 7.206122877840017]),
           24_000: ([0.9415460274197228, 0.7566719167158769], [7.602486866533044, 7.622280069290753])},
}
#   wire_accuracy.py (20 trials at -10, 2, 20 dB, 113 points): MAE deg by wire
JAX_WIRE = {"f32": [1.19, 1.079, 1.017], "i16": [1.19, 1.079, 1.017], "u8": [1.341, 1.079, 1.017],
            "u4": [1.313, 1.079, 1.017], "u8@12k": [1.029, 1.079, 1.05], "u4@12k": [1.19, 1.079, 1.06]}
#   reverb_robustness.py (20 trials, 10 dB, 112 points): MAE deg at reflections 0, 0.3, 0.5, 0.7, 0.9
JAX_REVERB = {"hilbert_mae_deg": [0.78, 3.44, 4.57, 7.0, 10.73],
              "xylo_matched_mae_deg": [0.78, 3.21, 5.16, 7.38, 12.97]}
#   snn_localization_benchmark.py [--sweep] (200 samples, 449 points): deg
JAX_BENCH = {"doa_mae_postprocessed": 0.0, "median": 126.9643, "robust_std": 0.0, "std": 0.0}
JAX_BENCH_SWEEP = [(0.0, 0.0, 0.6512), (0.0, 0.0, 1.0623), (0.0, 0.0, 1.3696), (0.0, 0.0, 1.5104), (0.0, 0.0, 0.7032),
                   (0.5281, 0.0, 1.5735)]  # (mae, robust std, raw std) a condition
#   phase_analysis.py: no grid; the card within 1e-3 relative (its float32 scan of the high-Q bandpass rounds
#   apart from XLA's by 6e-4 relative: tests/test_torch_bench_harnesses.py)
JAX_PHASE = {"overlapping_exponentials": {"f_inst_mean": 1699.99658203125, "f_inst_in_band_frac": 0.8999900783807917},
             "random_wideband_phase": {"f_inst_median": 1746.663330078125, "f_inst_iqr": 176.25146484375},
             "chirp_phase": {"freq_track_mae_hz": 7.96387235719594, "freq_track_p95_hz": 8.880402326007744}}
PHASE_RTOL = 1e-3
#   serving_throughput.py --sources=2 and --daemon --sources=2: printed, ungated (JAX gates neither)
JAX_TWO_SOURCES = {"nearest-source-frac@5deg": 0.03125, "both-sources-frac@10deg": 0.0}
GRID_STEP_113, GRID_STEP_449 = 360.0 / 112, 360.0 / 448
SERVE_WIRES = (("f32", 1), ("i16", 1), ("u8", 1), ("u4", 1), ("u8", 4), ("u4", 4))
XYLO_PATH = ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k3")
STREAM_PATH = ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k4")


def counted(torch, _build, label, expect, fn, seconds=None):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after; each kernel of ``expect`` must have launched.  ``seconds``, where
    given, receives the call's host seconds under ``label``."""
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    if seconds is not None:
        seconds[label] = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    missing = [k for k in expect if launches.get(k, 0) < 1]
    if missing:
        fail(f"{label}: {missing} never launched (launch counts {launches})")
    return out, launches


def xylo_twin(torch, label, card, host, frames, method):
    """The CPU twin ``host`` of the card's model ``card`` (the card's design
    and table, read back from the design cache): the same integers, the
    same DoAs from the same frames, and the card's ``cs`` through K1 -> K2
    -> pack -> K3 equal to the plain path's (``twin_counts``).  Returns the
    shape (B, T, C, N) and the hidden spikes counted."""
    same_xylo_design(card, host, label)
    if method == "matched" and not np.array_equal(card._profiles, host._profiles):
        fail(f"{label}: the CPU twin's matched profiles differ from the card's")
    d_card = card.forward_batch(frames, method=method)[0].cpu()
    d_host = host.forward_batch(frames.cpu(), method=method)[0]
    if not torch.equal(d_card, d_host):
        fail(f"{label}: the card's {method} DoAs differ from the CPU path's on frames "
             f"{torch.nonzero(d_card != d_host).flatten().tolist()}")
    tw = twin_counts(torch, label, card, host, frames)
    return tw.shape, int(tw.host_counts.sum())


def twin_counts(torch, label, card, host, frames, lif: bool = True):
    """The card's ``cs`` of ``frames`` through K1 -> K2 and, with ``lif``,
    the LIF pass (pack -> K3, or the raster pack -> K5 of a unipolar model)
    against the CPU twin ``host``'s plain path on the same ``cs``, mask by
    mask and count by count.  Returns the card's ``cs``, masks and counts,
    the twin's masks and counts (counts None without ``lif``) and the shape
    (B, T, C, N) (N 0 without ``lif``)."""
    cs = card.encode(frames)
    T, B, C = cs.shape
    kp, kn = card.rzcc(cs)
    host_kp, host_kn = host.rzcc(cs.cpu())
    bad = mismatches(kp, host_kp) + mismatches(kn, host_kn)
    if bad:
        fail(f"{label}: K1/K2's masks at (T, R) = ({T}, {B * C}) differ from the plain path's in {bad} entries")
    counts = host_counts = None
    if lif:
        counts, host_counts = card.lif_counts(kp, kn), host.lif_counts(host_kp, host_kn)
        bad = mismatches(counts, host_counts)
        if bad:
            fail(f"{label}: the LIF counts at (B, T, C, N) = ({B}, {T}, {C}, {counts.shape[1]}) differ from the "
                 f"plain path's in {bad} entries")
    return types.SimpleNamespace(cs=cs, kp=kp, kn=kn, counts=counts, host_kp=host_kp, host_kn=host_kn,
                                 host_counts=host_counts, shape=(B, T, C, 0 if counts is None else counts.shape[1]))


def check_bench_harnesses(torch, _build, sk, lk, StreamingLocalizer, dev, demo, frames, doas,
                          slice_doa):
    """Phase 23: the harnesses that time and check the ported paths, and the
    reverberant room, at the JAX harnesses' sizes (module docstring)."""
    import tempfile

    from haghighatshoarmuir2024_tpu_torch.experiments import analyse_array_localization as aal
    from haghighatshoarmuir2024_tpu_torch.experiments import design_time_probe as dtp
    from haghighatshoarmuir2024_tpu_torch.experiments import flagship_attribution as fa
    from haghighatshoarmuir2024_tpu_torch.experiments import mismatch_robustness as mm
    from haghighatshoarmuir2024_tpu_torch.experiments import phase_analysis as pa
    from haghighatshoarmuir2024_tpu_torch.experiments import reduced_rate as rr
    from haghighatshoarmuir2024_tpu_torch.experiments import reverb_robustness as rv
    from haghighatshoarmuir2024_tpu_torch.experiments import serving_throughput as st
    from haghighatshoarmuir2024_tpu_torch.experiments import snn_localization_benchmark as sb
    from haghighatshoarmuir2024_tpu_torch.experiments import wire_accuracy as wa
    from haghighatshoarmuir2024_tpu_torch.experiments.common import calibrated_demo
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import FRAME

    cpu = torch.device("cpu")
    out = {"s": {}, "launches": {}, "shapes": {}}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    saved_env = {k: os.environ.get(k) for k in ("HM2024_TORCH_CACHE", "HM2024_BENCH_DIR")}
    os.environ["HM2024_TORCH_CACHE"] = tmp.name  # the designs the harnesses make stay in the temp dir
    os.environ["HM2024_BENCH_DIR"] = os.path.join(tmp.name, "bench")
    B = frames.shape[0]
    tag = "[bench]"

    # ---- flagship_attribution on the flagship model and bench.py's frames
    res, out["launches"]["flagship_attribution"] = counted(
        torch, _build, "flagship_attribution", XYLO_PATH, lambda: fa.run(demo=demo, frames=(frames, doas)), out["s"])
    if res["doa"] != slice_doa.cpu().tolist():
        fail("flagship_attribution: its forward_batch(matched) DoAs differ from phase 5's (= the plain path's)")
    if res["doa_ok_frac_matched_5deg"] < 1.0:
        fail(f"flagship_attribution: doa-ok-frac {res['doa_ok_frac_matched_5deg']:.2f} @5deg (matched)")
    # the stages measured alone add up to the batch: the isolated RZCC and LIF against their in-program share,
    # within the spread of the readings that enter the sum
    spread = sum(res["spread_ms"][k] for k in ("encode", "[isolated] RZCC", "[isolated] LIF", "encode+RZCC+LIF",
                                                "forward_batch (peak)", "forward_batch (matched)"))
    gap = res["stage_sum_isolated_ms"] - res["stages_ms"]["TOTAL (matched)"]
    if abs(gap) > spread:
        fail(f"flagship_attribution: the stages measured alone sum to {res['stage_sum_isolated_ms']:.3f} ms against "
             f"forward_batch(matched)'s {res['stages_ms']['TOTAL (matched)']:.3f} ms, {gap:+.3f} ms, beyond the "
             f"readings' spread {spread:.3f} ms")
    out["attribution"] = res
    fa.print_stages(res)
    print(f"{tag} flagship_attribution (B = {B}, {res['reps']} calls x {res['rounds']} rounds, CUDA events): "
          f"{json.dumps({k: v for k, v in res.items() if k != 'doa'})}; the isolated stages sum to "
          f"{res['stage_sum_isolated_ms']:.3f} ms ({gap:+.3f} ms, spread {spread:.3f}); DoAs == phase 5's (the plain "
          f"path's), 1.00 @5deg; launches {out['launches']['flagship_attribution']}", flush=True)

    # ---- serving_throughput: the batched step (its first two steps = the plain step), then the daemon
    band = (1600, 1900)
    res, out["launches"]["serving_main"] = counted(torch, _build, "serving_throughput main", STREAM_PATH,
                                                   lambda: st.main(demo=demo), out["s"])
    if res["doa-ok-frac@5deg"] < 1.0:
        fail(f"serving_throughput main: doa-ok-frac {res['doa-ok-frac@5deg']} @5deg")
    chunks, s_doas, _ = st.stream_chunks(demo, B, FRAME, band)
    sl = StreamingLocalizer(demo)
    state, pstate = sl.init_state(B), sl.init_state(B)
    for k in range(2):
        state, sp = sl.process_chunk(state, chunks)
        pstate, psp = plain_step(torch, sk, lk, sl, pstate, chunks)
        bad = mismatches(sp, psp) + sum(mismatches(getattr(state, f), getattr(pstate, f))
                                        for f in ("counts", "isyn", "vmem", "spk"))
        if bad:
            fail(f"serving_throughput: step {k} on the harness's chunks: {bad} elements differ from the plain step")
    if not torch.equal(sl.estimate_doa(state, "matched"), sl.estimate_doa(pstate, "matched")):
        fail("serving_throughput: the batched step's DoAs differ from the plain path's")
    out["serving"] = {"main": res}
    res2 = st.main(demo=demo, sources=2)
    out["serving"]["main sources=2"] = res2
    print(f"{tag} serving_throughput main: {json.dumps(res)}; two steps on its chunks == the plain step (spikes, "
          f"counts, state, DoAs); launches {out['launches']['serving_main']}; --sources=2: {json.dumps(res2)} "
          f"(JAX's harness on the CPU: {JAX_TWO_SOURCES['nearest-source-frac@5deg']}, printed, ungated)", flush=True)
    os.environ["HM2024_SERVE_TIMING"] = "1"
    daemon_runs = [(False, w, u, 1) for w, u in SERVE_WIRES] + [(True, "i16", 1, 1), (True, "u4", 4, 1),
                                                                  (False, "i16", 1, 2)]
    for shm, wire, up, src in daemon_runs:
        label = (f"serving_throughput {'--shm' if shm else '--daemon'} --wire={wire}"
                 + (" --decim=4" if up == 4 else "") + (" --sources=2" if src == 2 else ""))
        answers = {}
        res, launches = counted(torch, _build, label, STREAM_PATH, lambda: st.daemon_main(
            use_shm=shm, wire=wire, wire_upsample=up, sources=src, demo=demo, answers=answers), out["s"])
        nb = res["streams"]
        if src == 2:
            if sorted(answers) != list(range(nb)) or any(np.asarray(a).shape != (2,) for a in answers.values()):
                fail(f"{label}: not every stream answered with two DoAs")
        else:
            if res["doa-ok-frac@5deg"] < 1.0:
                fail(f"{label}: doa-ok-frac {res['doa-ok-frac@5deg']} @5deg")
            chunks_d, _, _ = st.stream_chunks(demo, nb, FRAME, band)
            want = st.direct_answers(demo, st.wire_chunks(chunks_d, wire, up), 20 + 1, wire, up)
            got = np.float32([answers[i] for i in range(nb)])
            if not np.array_equal(got, want):
                fail(f"{label}: streams {np.flatnonzero(got != want).tolist()} answered otherwise than the direct "
                     "step on the decoded wire chunks")
        out["serving"][label] = res
        out["launches"][label] = launches
        print(f"{tag} {label}: {json.dumps(res)}" + ("" if src == 2 else "; every answer == the direct step on the "
              "decoded wire chunks") + (f" (JAX's harness on the CPU: {JAX_TWO_SOURCES['both-sources-frac@10deg']}, "
                                        "printed, ungated)" if src == 2 else "") + f"; launches {launches}", flush=True)

    # ---- reduced_rate at 48, 24 and 12 kHz (and --band=hi at 48 and 24); the 12 kHz shapes against the CPU twin
    for bname, band_r in (("lo", (1600, 1900)), ("hi", (2300, 2600))):
        demos, out["s"][f"reduced_rate {bname} designs"] = synced(
            torch, dev, lambda: {fs: calibrated_demo(113, fs=fs, freq_band=band_r, device=dev)
                                 for fs in JAX_REDUCED[bname]})
        res, launches = counted(torch, _build, f"reduced_rate {bname}", XYLO_PATH,
                                lambda: rr.run(band_r, 25, 113, dev, demos=demos), out["s"])
        out["launches"][f"reduced_rate {bname}"] = launches
        for row in res["rows"]:
            want_m, want_p = JAX_REDUCED[bname][row["fs"]]
            if not (within_step(row["matched_mae_deg"], want_m, GRID_STEP_113)
                    and within_step(row["peak_mae_deg"], want_p, GRID_STEP_113)):
                fail(f"reduced_rate {bname} {row['fs']}: matched {row['matched_mae_deg']}, peak {row['peak_mae_deg']} "
                     f"deg; JAX's harness {want_m}, {want_p} (gate: one grid step, {GRID_STEP_113:.2f})")
        out[f"reduced_rate {bname}"] = res
        print(f"{tag} reduced_rate {bname} {list(band_r)} Hz (25 trials at 0 / 10 dB, grid 113; JAX's harness in "
              "brackets): " + "; ".join(
                  f"{r['fs'] // 1000} kHz matched {np.round(r['matched_mae_deg'], 3).tolist()} "
                  f"[{np.round(JAX_REDUCED[bname][r['fs']][0], 3).tolist()}], peak "
                  f"{np.round(r['peak_mae_deg'], 3).tolist()} "
                  f"[{np.round(JAX_REDUCED[bname][r['fs']][1], 3).tolist()}], B = 96 forward_batch(matched) "
                  f"{r['forward_ms_b96']:.3f} ms = {r['audio_sec_per_sec']:.0f} audio-sec/sec, tau "
                  f"{r['tau_samples']:.2f} samples" for r in res["rows"]) + f"; launches {launches}", flush=True)
        if bname == "lo":
            d12 = demos[12_000]
            twin = calibrated_demo(113, fs=12_000, freq_band=band_r, device=cpu)
            frames12, _ = rr.trial_batch(d12, np.random.default_rng(0), 25, 0.0, band_r)
            (shape, n_sp), sec = synced(torch, dev, lambda: xylo_twin(torch, "reduced_rate 12 kHz", d12, twin, frames12,
                                                                      "matched"))
            dash = sorted(set(np.asarray(d12.xylo_config.dash_syn).ravel().tolist()))
            out["shapes"]["reduced_rate 12 kHz"] = shape
            print(f"{tag} reduced_rate 12 kHz on the CPU twin (the card's design and table, {sec:.1f} s): dash_syn "
                  f"{dash}; the matched DoAs of the 25 frames at 0 dB == the CPU path's; K1/K2 at (T, R) = "
                  f"({shape[1]}, {shape[0] * shape[2]}) and K3 at (B, T, C, N) = {shape} == the plain path's, count by "
                  f"count ({n_sp} spikes)", flush=True)

    # ---- wire_accuracy (the round trip through each wire, one forward_batch a wire and SNR)
    demo_w = calibrated_demo(113, device=dev)
    res, launches = counted(torch, _build, "wire_accuracy", XYLO_PATH, lambda: wa.run(demo=demo_w), out["s"])
    out["launches"]["wire_accuracy"] = launches
    for w, want in JAX_WIRE.items():
        got = [res[w][s] for s in (-10.0, 2.0, 20.0)]
        if not within_step(got, want, GRID_STEP_113):
            fail(f"wire_accuracy {w}: MAE {got} deg, JAX's harness {want} (gate: one grid step, {GRID_STEP_113:.2f})")
    out["wire"] = res
    frames_w, _ = wa.trial_frames(demo_w, np.random.default_rng(0), 20, -10.0)
    (shape, n_sp), sec = synced(torch, dev, lambda: xylo_twin(torch, "wire_accuracy", demo_w,
                                                              calibrated_demo(113, device=cpu),
                                                              torch.as_tensor(frames_w, device=dev), "matched"))
    out["shapes"]["wire_accuracy"] = shape
    print(f"{tag} wire_accuracy (20 trials, grid 113; MAE deg at -10 / 2 / 20 dB, JAX's harness in brackets): "
          + "; ".join(f"{w} {[res[w][s] for s in (-10.0, 2.0, 20.0)]} [{JAX_WIRE[w]}]" for w in JAX_WIRE)
          + f"; launches {launches}; the CPU twin ({sec:.1f} s): DoAs == the CPU path's, K3 at (B, T, C, N) = {shape} "
          f"== the plain path's ({n_sp} spikes)", flush=True)

    # ---- the live-style benchmark: a run of 200 samples, saved and analysed, and the sweep
    demo_b = sb.make_demo(device=dev)
    res, launches = counted(torch, _build, "snn_localization_benchmark", XYLO_PATH, lambda: sb.run(200, demo=demo_b),
                            out["s"])
    out["launches"]["snn_localization_benchmark"] = launches
    col = res["collected"]
    if not within_step([col[k] for k in JAX_BENCH], list(JAX_BENCH.values()), GRID_STEP_449):
        fail(f"snn_localization_benchmark: {[col[k] for k in JAX_BENCH]} for {list(JAX_BENCH)}, JAX's harness "
             f"{list(JAX_BENCH.values())} (gate: one grid step, {GRID_STEP_449:.3f})")
    sweep, out["s"]["benchmark sweep"] = synced(torch, dev, lambda: sb.sweep(200, demo=demo_b))
    got = [(r["mae_deg"], r["robust_std_deg"], r["raw_std_deg"]) for r in sweep["conditions"]]
    if not within_step(got, JAX_BENCH_SWEEP, GRID_STEP_449):
        fail(f"snn_localization_benchmark sweep: (mae, robust std, raw std) {got}, JAX's harness {JAX_BENCH_SWEEP} "
             f"(gate: one grid step, {GRID_STEP_449:.3f})")
    analysed = aal.analyse([os.environ["HM2024_BENCH_DIR"]])["bench"]
    if len(analysed) != 1 or next(iter(analysed.values()))["run_median"] != round(col["median"], 4):
        fail(f"analyse_array_localization: {analysed} does not analyse the run the benchmark saved")
    out["benchmark"] = {"run": res, "sweep": sweep, "analysed": analysed}
    demo_b_cpu = sb.make_demo(device=cpu)
    sig = sb.clean_frame(demo_b, (1600, 2000), 2.2439)  # the run's frames: the chirp at 10 dB
    sigma = float(torch.sqrt(torch.mean(sig**2) / 10.0))
    frames_b = sig + sigma * torch.randn((20, *sig.shape), generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    (shape, n_sp), sec = synced(torch, dev, lambda: xylo_twin(torch, "snn_localization_benchmark", demo_b, demo_b_cpu,
                                                              frames_b, "peak"))
    out["shapes"]["snn_localization_benchmark"] = shape
    print(f"{tag} snn_localization_benchmark (200 samples, 0.4 s frames, grid 449, peak): {json.dumps(col)} (JAX's "
          f"harness {JAX_BENCH}); sweep (mae, robust std, raw std) {got} (JAX's {JAX_BENCH_SWEEP}; gate +- "
          f"{GRID_STEP_449:.3f}) in {out['s']['benchmark sweep']:.2f} s; analyse_array_localization of the saved run: "
          f"{json.dumps(analysed)}; launches {launches}; the CPU twin ({sec:.1f} s): peak DoAs == the CPU path's, "
          f"K3 at "
          f"(B, T, C, N) = {shape} == the plain path's ({n_sp} spikes)", flush=True)

    # ---- reverb_robustness: one Hilbert scan and one rates_batch a coefficient
    model = mm.build(16 * 7, device=dev)
    res, launches = counted(torch, _build, "reverb_robustness", XYLO_PATH, lambda: rv.run(20, 16 * 7, model=model),
                            out["s"])
    out["launches"]["reverb_robustness"] = launches
    n_coef = len(rv.REFLECTIONS)
    for name in ("rzcc_k1", "lif_pack", "lif_k3"):
        if launches.get(name, 0) != n_coef:
            fail(f"reverb_robustness: {name} launched {launches.get(name, 0)} times for {n_coef} batches")
    for key, want in JAX_REVERB.items():
        if not within_step(res[key], want, GRID_STEP_112):
            fail(f"reverb_robustness {key}: {res[key]} deg, JAX's harness {want} (gate: one grid step, "
                 f"{GRID_STEP_112:.2f})")
    out["reverb"] = res
    t = np.arange(0, 0.25, 1 / 48_000)
    f32 = dict(dtype=torch.float32, device=dev)
    tables = rv.path_tables(rv.sample_positions(np.random.default_rng(SEED), 20), 0.7)
    frames_r = rv.trial_frames(model[2].geometry, torch.as_tensor(t, **f32),
                               torch.as_tensor(np.sin(2 * np.pi * 1750.0 * t), **f32), tables,
                               torch.randn((20, len(t), 7), generator=torch.Generator(dev).manual_seed(SEED), **f32))
    (shape, n_sp), sec = synced(torch, dev, lambda: xylo_twin(torch, "reverb_robustness", model[2],
                                                              mm.build_demo(16 * 7, device=cpu), frames_r, "matched"))
    out["shapes"]["reverb_robustness"] = shape
    print(f"{tag} reverb_robustness (20 trials, 10 dB, grid 112; MAE deg at reflections {rv.REFLECTIONS}): Hilbert "
          f"{res['hilbert_mae_deg']} [JAX {JAX_REVERB['hilbert_mae_deg']}], Xylo matched {res['xylo_matched_mae_deg']} "
          f"[JAX {JAX_REVERB['xylo_matched_mae_deg']}]; launches {launches} for {n_coef} batches; the CPU twin at "
          f"reflection 0.7 ({sec:.1f} s): DoAs == the CPU path's, K3 at (B, T, C, N) = {shape} == the plain path's "
          f"({n_sp} spikes)", flush=True)

    # ---- phase_analysis and design_time_probe
    res, out["s"]["phase_analysis"] = synced(torch, dev, lambda: pa.run(dev))
    for group, rows in JAX_PHASE.items():
        for k, want in rows.items():
            if not abs(res[group][k] - want) <= PHASE_RTOL * abs(want):
                fail(f"phase_analysis {group} {k}: {res[group][k]}, JAX's harness {want} (gate {PHASE_RTOL} relative)")
    out["phase"] = res
    probe = dtp.run(device=dev)
    out["design_probe"] = probe
    print(f"{tag} phase_analysis: {json.dumps(res)} (JAX's harness within {PHASE_RTOL} relative); design_time_probe: "
          f"{json.dumps(probe)}", flush=True)

    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------ phase 24
# Every accuracy gate of phase 24 that compares with JAX is what the JAX package's own harness prints today at
# the same configuration on the CPU, at seeds 0 and 1 (its own jax.random draws; stage A and the ordering
# harness draw with numpy, as the port's twins do):
#   JAX_PLATFORMS=cpu HM2024_JAX_CACHE=0 python tests/test_torch_speech_harnesses.py --jax-gates JOB 0 1
# with JOB speech (run_speech, 100 trials, 112 points, 1.0 s) and speech_uni (20 trials), multiband and
# cross_segment (multiband_speech.run / run_cross_segment, 50 trials), ordering and stht.  JAX's CLI computes
# its synthetic speech in float32, the port in float64 (as JAX under x64): 5e-4 of the peak apart.
#   MAE deg a column: speech_mc's three estimators at the 11 SNRs, then template/column at -10, 0, 10, 20 dB
JAX_SPEECH = {
    0: {
        "reference_peak": [40.0717, 34.098, 27.8936, 21.3328, 16.6421, 15.1886, 15.3401, 14.2413, 15.9127, 14.7002,
                           14.8802],
        "matched_tone_cal": [38.4957, 28.9541, 20.9167, 12.6478, 10.2762, 8.947, 7.9646, 7.7823, 7.5914, 7.6433,
                             7.6229],
        "matched_speech_cal": [42.8694, 37.6027, 29.9997, 20.8784, 13.2015, 9.8928, 7.4177, 5.1855, 3.3825, 2.5688,
                               2.2451],
        "tone/reference_peak": [4.3123, 10.6462, 10.8794, 11.5597],
        "tone/matched_tone_cal": [2.8739, 2.0703, 1.4455, 1.3809],
        "tone/matched_self_cal": [2.8739, 2.0703, 1.4455, 1.3809],
        "chirp/reference_peak": [3.8665, 11.0486, 11.7515, 11.5067],
        "chirp/matched_tone_cal": [3.2543, 2.3411, 2.3403, 2.2394],
        "chirp/matched_self_cal": [2.1131, 1.0071, 0.7475, 0.7495],
        "speech/reference_peak": [40.6398, 20.0354, 16.1759, 14.8844],
        "speech/matched_tone_cal": [33.763, 11.0809, 7.1589, 7.2591],
        "speech/matched_self_cal": [37.3339, 18.5822, 5.6218, 2.0785],
    },
    1: {
        "reference_peak": [40.6398, 34.16, 28.2891, 22.2072, 19.2165, 17.4399, 16.6031, 15.6908, 15.8966, 15.9358,
                           14.8844],
        "matched_tone_cal": [33.763, 25.0929, 16.4179, 12.2991, 8.8453, 8.7993, 8.0072, 6.857, 6.6359, 7.054, 7.2591],
        "matched_speech_cal": [37.3339, 34.0054, 26.6055, 18.8982, 14.2329, 9.7542, 6.6091, 5.3031, 3.8036, 2.9032,
                               2.0785],
        "tone/reference_peak": [4.8232, 9.0928, 9.7827, 10.5389],
        "tone/matched_tone_cal": [3.0583, 2.1719, 1.5025, 1.4009],
        "tone/matched_self_cal": [3.0583, 2.1719, 1.5025, 1.4009],
        "chirp/reference_peak": [4.5545, 9.49, 9.9402, 9.2754],
        "chirp/matched_tone_cal": [3.4592, 2.4857, 2.3547, 2.091],
        "chirp/matched_self_cal": [2.3946, 1.1789, 0.8726, 0.8599],
        "speech/reference_peak": [41.1693, 20.5903, 17.0671, 14.3493],
        "speech/matched_tone_cal": [39.2556, 12.6404, 7.3541, 7.2324],
        "speech/matched_self_cal": [42.8815, 19.6017, 6.1298, 2.2207],
    },
}
JAX_SPEECH_UNI = {
    0: {
        "reference_peak": [39.3029, 40.0326, 40.2758, 40.2758, 40.2758, 40.1137, 39.6272, 39.8704, 39.9515, 40.5191,
                           39.9515],
        "matched_tone_cal": [45.564, 35.3105, 36.3482, 30.661, 35.1723, 31.1382, 28.2388, 24.3706, 20.1435, 18.9937,
                             15.4337],
        "matched_speech_cal": [37.982, 37.982, 37.982, 37.982, 37.982, 37.982, 37.982, 32.6665, 26.0076, 22.1157,
                               19.002],
        "tone/reference_peak": [43.7719, 24.7038, 18.6521, 22.1232],
        "tone/matched_tone_cal": [5.1736, 2.5219, 1.9558, 1.4452],
        "tone/matched_self_cal": [5.1736, 2.5219, 1.9558, 1.4452],
        "chirp/reference_peak": [43.8371, 29.1116, 24.8143, 21.2673],
        "chirp/matched_tone_cal": [6.5307, 2.3825, 2.0274, 2.1687],
        "chirp/matched_self_cal": [5.6724, 1.6676, 0.693, 0.693],
        "speech/reference_peak": [43.8371, 43.3506, 43.5286, 44.1773],
        "speech/matched_tone_cal": [40.1112, 36.0357, 32.7426, 22.1456],
        "speech/matched_self_cal": [48.4677, 48.4677, 42.3056, 23.8918],
    },
    1: {
        "reference_peak": [43.8371, 44.0804, 44.0151, 44.5016, 44.0804, 44.5669, 44.2583, 44.0804, 44.2583, 44.4205,
                           44.1773],
        "matched_tone_cal": [40.1112, 39.2254, 37.5325, 36.0357, 39.6998, 39.6998, 36.0843, 30.6641, 30.6094, 27.3086,
                             22.1456],
        "matched_speech_cal": [48.4677, 48.4677, 48.4677, 48.4677, 48.4677, 48.4677, 48.4677, 36.9692, 32.3053,
                               26.8523, 23.8918],
        "tone/reference_peak": [45.1796, 32.192, 31.64, 29.8562],
        "tone/matched_tone_cal": [5.8272, 1.4833, 1.8488, 1.6586],
        "tone/matched_self_cal": [5.8272, 1.4833, 1.8488, 1.6586],
        "chirp/reference_peak": [45.1796, 41.2877, 36.8292, 34.7933],
        "chirp/matched_tone_cal": [8.1897, 2.8187, 2.2941, 2.163],
        "chirp/matched_self_cal": [5.5668, 1.1293, 0.8925, 0.8925],
        "speech/reference_peak": [45.4228, 45.0184, 44.8562, 45.3732],
        "speech/matched_tone_cal": [43.7457, 31.7544, 23.81, 20.987],
        "speech/matched_self_cal": [40.1566, 40.1566, 25.4639, 21.2335],
    },
}
#   stage A at seed 0 (numpy noise, the same arrays on the card): peak, matched tone, matched speech error deg,
#   sidelobe dB
JAX_BEAM = {
    True: {"-10dB": [37.2973, 11.3513, 4.8649, 0.0], "+0dB": [35.6757, 51.8919, 29.1892, -0.0056],
           "+10dB": [69.7297, 37.2973, 89.1892, -0.0328], "+20dB": [34.0541, 11.3513, 1.6216, -0.0578]},
    False: {"-10dB": [87.5676, 25.9459, 64.8649, -0.0017], "+0dB": [87.5676, 61.6216, 64.8649, -0.0189],
            "+10dB": [87.5676, 61.6216, 64.8649, -0.0291], "+20dB": [87.5676, 61.6216, 64.8649, -0.005]},
}
SIDELOBE_DB = 0.5
# Stage A's errors of the unipolar model are held to JAX's on its peak error and sidelobe; its matched errors are
# held to the CPU twin of the card's design instead, DoA by DoA: its speech profile has near-equal peaks (JAX's
# sidelobe -0.002 to -0.03 dB), and which wins follows the design's rounding and unit phase (each LAPACK's).
# Measured on the CPU with the same numpy noise: the port on JAX's design gives JAX's errors exactly (the CPU
# tests), on its own CPU design 25.9/61.6 and 55.1/76.2 deg, and the card on its design 16.2 and 56.8, against
# JAX's 25.9/61.6 and 64.9.  Both models' stage A DoAs equal the twin's
BEAM_GATED = {True: (0, 1, 2), False: (0,)}
#   multiband_speech run (single/ and three/ columns at -10, -4, 2, 8, 14, 20 dB) and run_cross_segment (-4, 8, 20 dB)
JAX_MB_SPEECH = {
    0: {"single/reference_peak": [41.83, 27.41, 14.57, 14.53, 15.7, 14.76],
        "single/matched_speech_cal": [44.65, 29.62, 13.77, 7.96, 3.37, 1.98],
        "three/reference_peak": [27.89, 25.29, 24.59, 24.72, 21.4, 17.69],
        "three/matched_speech_cal": [20.88, 16.93, 13.83, 17.81, 13.84, 7.72],
        "three/matched_band_stacked": [30.24, 26.96, 26.62, 25.63, 20.28, 7.88],
        "three/matched_band_cos": [35.54, 21.05, 8.67, 5.47, 2.56, 1.62],
        "three/matched_band_cosfold": [32.14, 17.85, 8.28, 5.27, 3.09, 1.77],
        "three/matched_auto_peak": [29.68, 16.22, 8.02, 5.35, 2.77, 1.77],
        "three/matched_auto_peak2": [27.53, 15.78, 7.93, 5.15, 2.65, 1.77],
        "three/matched_auto_contrast": [31.82, 17.23, 8.61, 5.68, 2.66, 1.73],
        "cross/self_segment": [21.05, 5.47, 1.62], "cross/cross_segment": [21.05, 5.47, 1.62]},
    1: {"single/reference_peak": [41.46, 29.1, 22.24, 16.79, 17.04, 15.39],
        "single/matched_speech_cal": [37.11, 23.03, 14.63, 7.11, 4.01, 2.24],
        "three/reference_peak": [23.32, 23.78, 20.94, 22.09, 19.86, 16.68],
        "three/matched_speech_cal": [21.41, 14.4, 10.16, 13.84, 12.07, 7.83],
        "three/matched_band_stacked": [25.71, 24.68, 21.78, 20.01, 13.85, 7.68],
        "three/matched_band_cos": [34.71, 22.55, 8.7, 4.18, 2.53, 1.68],
        "three/matched_band_cosfold": [31.0, 18.72, 8.22, 4.45, 2.95, 2.05],
        "three/matched_auto_peak": [28.74, 17.96, 8.47, 4.25, 2.66, 2.03],
        "three/matched_auto_peak2": [27.62, 16.48, 8.51, 4.05, 2.67, 2.09],
        "three/matched_auto_contrast": [29.1, 18.54, 8.51, 4.1, 2.82, 2.07],
        "cross/self_segment": [22.55, 4.18, 1.68], "cross/cross_segment": [22.55, 4.18, 1.68]},
}
#   xylo_ordering_sensitivity --speech, cut to 10 trials at 10 dB (the simulator is a host-bound loop, 230-249 us a
#   step): MAE deg a step convention, printed beside JAX's (the same numpy draws) and held to the CPU twin of the
#   card's design, trial by trial: at an MAE of 25-42 deg the peak estimator has near-equal peaks, and a moved
#   spike or the design's rounding flips a trial between them.  Measured: decay_first/zero 25.52 in JAX, 28.41
#   through the port on JAX's design on the CPU (its own encode), 30.50 on the port's own CPU design, 30.66 on the
#   card; the other three conventions within 0.49 deg of JAX's everywhere.  On JAX's rasters the port gives JAX's
#   MAE exactly (tests/test_torch_multiband_speech.py)
ORDERING_SIMS, ORDERING_GRID, ORDERING_SEC = 10, 225, 0.25
ORDERING_ARGV = ["--speech", "--sims", str(ORDERING_SIMS), "--snrs", "10", "--json"]
JAX_ORDERING = {"decay_first/subtract": 42.2185, "decay_first/zero": 25.5183, "integrate_first/subtract": 24.8316,
                "integrate_first/zero": 29.653}
#   short_hilbert_transform: the STHT against scipy's Hilbert transform, gated within 1e-4 (absolute); the RZCC count
JAX_STHT = {"5ms": (1.4276891473384878e-07, 6.096160343320514e-07),
            "10ms": (1.1106067597753103e-07, 4.904070233044033e-07),
            "20ms": (1.3496198085186918e-07, 5.500115771418575e-07)}
JAX_STHT_SPIKES = 100
STHT_TOL = 1e-4
SPEECH_TRIALS, SPEECH_UNI_TRIALS, MB_TRIALS = 100, 20, 50
# The seeds' range alone is no yardstick at low SNR: a card run (H100, 700 W) put three of bipolar run_speech's
# columns beyond JAX's two seeds plus a step (the reference and the tone-matched at -7 dB by 0.48 and 1.31 deg, the
# speech trials' reference at -10 dB by 3.93), where a trial's error spreads over tens of degrees and a mean of
# 100 trials moves by a few degrees between draws.  So each MAE must lie within one grid step of the two seeds'
# mean, widened by the larger of half the seeds' spread (the issue's range) and DRAW_Z standard errors of the
# difference between the card's mean of n trials and the seeds' mean of 2n: sd·sqrt(1/n + 1/(2n)), sd the per-trial
# standard deviation of JAX's errors pooled over its two seeds (the pooled_sd_deg line of --jax-gates JOB 0 1).
# DRAW_Z = 4: a right port falls outside one entry with a chance of 6e-5, any of the about 200 gated entries about 1 %
DRAW_Z = 4.0
JAX_SPEECH_SD = {
    "reference_peak": [26.1477, 23.1792, 21.9975, 16.4967, 14.0729, 12.2319, 11.4121, 10.6084, 10.7178, 10.6387,
                       10.5824],
    "matched_tone_cal": [25.6383, 22.3195, 16.601, 9.5732, 7.3232, 6.6356, 6.2523, 5.7638, 6.1228, 6.3209, 6.4044],
    "matched_speech_cal": [26.4941, 24.3127, 21.4087, 16.2569, 10.5087, 7.9845, 5.7546, 4.6299, 2.9328, 2.4406, 1.7821],
    "tone/reference_peak": [3.1649, 7.0124, 7.2617, 7.4508],
    "tone/matched_tone_cal": [2.2686, 1.5862, 1.2036, 1.2418],
    "tone/matched_self_cal": [2.2686, 1.5862, 1.2036, 1.2418],
    "chirp/reference_peak": [2.8771, 6.489, 7.0141, 6.8341],
    "chirp/matched_tone_cal": [2.4592, 1.8441, 1.7464, 1.6684],
    "chirp/matched_self_cal": [1.4278, 0.803, 0.4951, 0.4871],
    "speech/reference_peak": [24.725, 15.0487, 11.0127, 10.542],
    "speech/matched_tone_cal": [25.0202, 9.411, 5.9549, 5.6108],
    "speech/matched_self_cal": [26.5207, 16.6668, 4.6814, 1.6314],
}
JAX_SPEECH_UNI_SD = {
    "reference_peak": [28.3068, 28.9745, 28.5369, 28.4416, 27.9858, 28.4777, 28.1725, 27.8671, 27.9485, 27.9913,
                       28.4397],
    "matched_tone_cal": [27.2472, 25.403, 25.3711, 25.0084, 26.4648, 26.5744, 25.0545, 24.6997, 24.5891, 21.5786,
                         18.1418],
    "matched_speech_cal": [26.9521, 26.9521, 26.9521, 26.9521, 26.9521, 26.9521, 26.9521, 23.2768, 20.3016, 19.4926,
                           18.1593],
    "tone/reference_peak": [26.5916, 22.8665, 20.9893, 22.2827],
    "tone/matched_tone_cal": [3.8541, 1.6336, 1.5813, 1.4097],
    "tone/matched_self_cal": [3.8541, 1.6336, 1.5813, 1.4097],
    "chirp/reference_peak": [26.6481, 25.271, 23.1482, 21.2525],
    "chirp/matched_tone_cal": [5.1349, 2.1686, 2.0574, 2.0055],
    "chirp/matched_self_cal": [3.4828, 1.0075, 0.444, 0.444],
    "speech/reference_peak": [26.7914, 26.6767, 26.3177, 27.4608],
    "speech/matched_tone_cal": [24.7335, 22.9437, 22.9337, 21.332],
    "speech/matched_self_cal": [25.0865, 25.0865, 21.2769, 19.0143],
}
JAX_MB_SPEECH_SD = {
    "single/reference_peak": [27.124, 23.0543, 13.3807, 11.1626, 10.9011, 10.8802],
    "single/matched_speech_cal": [27.5068, 21.4822, 11.2355, 6.0425, 3.2101, 1.6553],
    "three/reference_peak": [18.7151, 16.9347, 18.2386, 15.9882, 15.508, 14.0748],
    "three/matched_speech_cal": [16.913, 15.2575, 11.0338, 14.2543, 9.296, 5.4754],
    "three/matched_band_stacked": [18.2453, 17.6856, 19.3242, 18.5737, 15.9929, 7.7326],
    "three/matched_band_cos": [24.4667, 16.5579, 6.2516, 3.7834, 2.1058, 1.2427],
    "three/matched_band_cosfold": [23.6019, 13.8552, 6.743, 4.5128, 2.3875, 1.5573],
    "three/matched_auto_peak": [22.8505, 13.7468, 6.5243, 4.6063, 2.2644, 1.5594],
    "three/matched_auto_peak2": [21.8115, 13.8576, 6.2999, 4.424, 2.28, 1.5502],
    "three/matched_auto_contrast": [23.883, 13.7567, 6.7522, 4.6723, 2.3384, 1.5328],
    "cross/self_segment": [16.5579, 3.7834, 1.2427],
    "cross/cross_segment": [16.5579, 3.7834, 1.2427],
}
RASTER_PATH = ("rzcc_k1", "rzcc_k2", "lif_pack_raster", "lif_k5")


def seed_gaps(got, seeds, sd, n: int, step: float):
    """How far each entry of ``got`` (a mean over ``n`` trials) lies outside
    its gate: one grid ``step`` around the two seeds' mean, widened by the
    larger of half their spread and ``DRAW_Z`` standard errors of the
    card's mean against theirs, ``sd · sqrt(1.5 / n)`` (``sd``: JAX's
    per-trial deviation); 0 where inside."""
    a, b = (np.asarray(x, np.float64) for x in seeds)
    got = np.asarray(got, np.float64)
    spread = np.maximum(np.abs(a - b) / 2, DRAW_Z * np.asarray(sd, np.float64) * np.sqrt(1.5 / n))
    return np.maximum(0.0, np.abs(got - (a + b) / 2) - step - spread - 5e-3)  # 5e-3: JAX's printed rounding


def speech_columns(res) -> dict:
    """``run_speech``'s MAE columns under ``JAX_SPEECH``'s names."""
    cols = {lab: res["speech_mc"][lab]["mae_deg"]
            for lab in ("reference_peak", "matched_tone_cal", "matched_speech_cal")}
    for tpl, rows in res["calibration_robustness"].items():
        cols.update({f"{tpl}/{k[:-8]}": v for k, v in rows.items() if k.endswith("_mae_deg")})
    return cols


def gate_columns(problems, label, cols, jax_seeds, jax_sd, n: int, step: float):
    """Record the columns of ``n`` trials that lie outside their gate
    (``seed_gaps``) around JAX's two seeds."""
    if not sorted(cols) == sorted(jax_seeds[0]) == sorted(jax_sd):
        problems.append(f"{label}: columns {sorted(set(cols) ^ set(jax_seeds[0]))} do not match JAX's")
        return
    for k, v in cols.items():
        gap = seed_gaps(v, (jax_seeds[0][k], jax_seeds[1][k]), jax_sd[k], n, step)
        if gap.max() > 0:
            problems.append(f"{label} {k}: {np.round(v, 2).tolist()} deg, JAX's seeds {jax_seeds[0][k]} / "
                            f"{jax_seeds[1][k]} (per-trial sd {jax_sd[k]}, {n} trials): outside by "
                            f"{np.round(gap, 2).tolist()}")


def rate_of(torch, demo, counts, T: int):
    """Counts (B, N) over T steps → the rates ``Demo.rates_batch`` gives."""
    return counts.to(torch.float32) / T * demo.fs


def batch_against_plain(torch, sk, lk, roofline, label, demo, host, frames, peaks_per_s, doas):
    """One trial batch of a harness on the card held against the CPU twin
    ``host`` (``twin_counts``: K1/K2's masks and the LIF counts, K3 from the
    masks or K5 from the raster of a unipolar model, count by count), and the
    DoAs ``doas(demo, rates (B, F·G))`` the harness reads from the card's
    counts equal to those the twin reads from its own on the CPU.  Times
    K1 + K2 (one ``rzcc``, its host flag read included) and the LIF pass
    (pack + K3, or raster pack + K5; the integers uploaded once) by CUDA
    events beside their bounds (``experiments/roofline``, at
    ``peaks_per_s``).  Returns the shape (B, T, C, N), the input spikes
    counted and the times."""
    tw = twin_counts(torch, label, demo, host, frames)
    cs, kp, kn = tw.cs, tw.kp, tw.kn
    B, T, C, N = tw.shape
    if not torch.equal(doas(demo, rate_of(torch, demo, tw.counts, T)).cpu(),
                       doas(host, rate_of(torch, host, tw.host_counts, T))):
        fail(f"{label}: the DoAs of the card's counts differ from the CPU twin's")
    params = demo.lif_params()
    w, W = sk._windows(demo.robust_width, 2 * demo.robust_width)
    work = roofline.rzcc_work(cs.reshape(T, B * C), w, W)
    if demo.bipolar_spikes:
        lif = roofline.lif_bipolar_work(kp, kn, N)
        lif_parts, lif_fn = ("lif_pack", "lif_k3"), lambda: lk.lif_count_rates_bipolar(params, kp, kn)
    else:
        lif = {"lif_pack_raster": roofline.pack_raster_work(T, B, C),
               "lif_k5": roofline.lif_work(int(kp.sum()), T, B, N, C)}
        lif_parts, lif_fn = ("lif_pack_raster", "lif_k5"), lambda: lk.lif_count_rates(params, kp, time_major=True)
    bounds = roofline.bounds({**work, **lif}, peaks_per_s)
    times = {"rzcc_ms": timed_ms(torch, lambda: demo.rzcc(cs), 5),
             "rzcc_bound_ms": bounds["rzcc_k1"][0] + bounds["rzcc_k2"][0],
             "lif_ms": timed_ms(torch, lif_fn, 5), "lif_bound_ms": sum(bounds[k][0] for k in lif_parts),
             "lif": " + ".join(lif_parts)}
    return tw.shape, int(kp.sum() + (kn.sum() if demo.bipolar_spikes else 0)), times


def check_speech_harnesses(torch, _build, sk, lk, roofline, StreamingLocalizer, dev, demo, frames, peaks_per_s):
    """Phase 24: the speech harnesses, the STHT analysis and one stream
    through the single-stream path (module docstring)."""
    import contextlib
    import io
    import tempfile

    from haghighatshoarmuir2024_tpu_torch.experiments import multiband_speech as mbs
    from haghighatshoarmuir2024_tpu_torch.experiments import short_hilbert_transform as stht_h
    from haghighatshoarmuir2024_tpu_torch.experiments import target_xylo_localization as txl
    from haghighatshoarmuir2024_tpu_torch.experiments import xylo_ordering_sensitivity as xos
    from haghighatshoarmuir2024_tpu_torch.experiments.common import FS, SPEECH_FLAC, speech_template
    from haghighatshoarmuir2024_tpu_torch.parallel import make_trial_fn

    out = {"s": {}, "launches": {}, "shapes": {}, "kernel_times": {}}
    problems = []  # the accuracy gates' failures, reported together at the phase's end
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    tmp = tempfile.TemporaryDirectory()
    saved_cache = os.environ.get("HM2024_TORCH_CACHE")
    os.environ["HM2024_TORCH_CACHE"] = tmp.name  # the card's designs, read back by their CPU twins
    tag = "[speech]"
    t_sp, s_sp = speech_template(duration=1.0)
    source = "the LibriSpeech sample" if os.path.exists(SPEECH_FLAC) else "the synthetic fallback"
    gen = torch.Generator(device=dev)

    def trial_frames(demo_, n, snr_db):
        gen.manual_seed(SEED + 24)
        return make_trial_fn(demo_.geometry, t_sp, s_sp, lambda f: f, FS, device=dev)(gen, snr_db, n)[1]

    # ---- run_speech, bipolar and unipolar
    for bipolar, trials, jax_cols, jax_sd in ((True, SPEECH_TRIALS, JAX_SPEECH, JAX_SPEECH_SD),
                                              (False, SPEECH_UNI_TRIALS, JAX_SPEECH_UNI, JAX_SPEECH_UNI_SD)):
        name = "speech" if bipolar else "speech unipolar"
        demo_s, out["s"][f"{name} design"] = synced(torch, dev, lambda: txl.build_demo(bipolar, 112, 1.0, dev))
        res, out["launches"][name] = counted(torch, _build, name, XYLO_PATH if bipolar else RASTER_PATH,
                                             lambda: txl.run_speech(bipolar=bipolar, num_sims=trials, demo=demo_s),
                                             out["s"])
        cols = speech_columns(res)
        gate_columns(problems, name, cols, jax_cols, jax_sd, trials, GRID_STEP_112)
        for snr, (peak, tone, speech, side) in JAX_BEAM[bipolar].items():
            b = res["beam_profiles"][snr]
            got = [b["peak_err_deg"], b["matched_tone_err_deg"], b["matched_speech_err_deg"]]
            gated = list(BEAM_GATED[bipolar])
            if (not within_step(np.take(got, gated), np.take([peak, tone, speech], gated), GRID_STEP_112)
                    or abs(b["sidelobe_db"] - side) > SIDELOBE_DB):
                problems.append(
                    f"{name} stage A at {snr}: errors {np.round(got, 3).tolist()} deg, sidelobe {b['sidelobe_db']:.3f} "
                    f"dB; JAX's on the same numpy noise {[peak, tone, speech]}, {side} (gates: one grid step on "
                    f"entries {gated}, {SIDELOBE_DB} dB)")
        # the CPU twin: the card's design and tables, read back; stage A's frames and one batch of trials
        t0 = time.perf_counter()
        host = txl.build_demo(bipolar, 112, 1.0, cpu)
        same_xylo_design(demo_s, host, name)
        card_tables = [torch.as_tensor(np.asarray(demo_s.calibrate_profiles(template=tpl), np.float32), device=dev)
                       for tpl in (None, (t_sp, s_sp))]
        tables = {True: card_tables, False: [p.cpu() for p in card_tables]}  # keyed by "on the card"

        def doas(d, rate):
            return txl.speech_estimators(d, d.fold(rate), tables[d is demo_s])

        tw = twin_counts(torch, f"{name} stage A", demo_s, host, txl.beam_frames(demo_s, t_sp, s_sp))
        est_a = doas(demo_s, rate_of(torch, demo_s, tw.counts, tw.shape[1])).cpu()
        if not torch.equal(est_a, doas(host, rate_of(torch, host, tw.host_counts, tw.shape[1]))):
            fail(f"{name} stage A: the card's DoAs {est_a.tolist()} differ from the CPU twin's")
        err_a = np.degrees(np.arcsin(np.abs(np.sin(est_a.numpy()))))
        printed = [[b["peak_err_deg"], b["matched_tone_err_deg"], b["matched_speech_err_deg"]]
                   for b in res["beam_profiles"].values()]
        if not np.array_equal(err_a, np.asarray(printed)):
            fail(f"{name} stage A: the errors of its frames' DoAs {err_a.tolist()} are not those run_speech printed "
                 f"{printed}")
        shape, n_sp, out["kernel_times"][name] = batch_against_plain(
            torch, sk, lk, roofline, name, demo_s, host, trial_frames(demo_s, 20, 0.0), peaks_per_s, doas)
        out["s"][f"{name} CPU twin"] = time.perf_counter() - t0
        out["shapes"][name] = shape
        out[name] = res
        print(f"{tag} run_speech {'bipolar' if bipolar else 'unipolar'} ({trials} trials x 11 SNRs, grid 112, 1.0 s of "
              f"{source}; JAX's harness at seeds 0 / 1 in brackets, gate: one grid step ({GRID_STEP_112:.2f} deg) "
              f"and the larger of half their spread and {DRAW_Z} standard errors around their mean): "
              + "; ".join(f"{k} {np.round(v, 2).tolist()} [{np.round(jax_cols[0][k], 2).tolist()} / "
                          f"{np.round(jax_cols[1][k], 2).tolist()}]" for k, v in cols.items())
              + "; stage A " + json.dumps({k: {kk: round(vv, 3) for kk, vv in v.items() if kk != "profile"}
                                           for k, v in res["beam_profiles"].items()})
              + f" (entries {list(BEAM_GATED[bipolar])} gated against JAX's); on the CPU twin of the card's design "
              f"({out['s'][f'{name} CPU twin']:.1f} s): stage A's four frames' DoAs equal and K1/K2 + "
              f"{'K3' if bipolar else 'the raster pack + K5'} on their cs == the plain path's; one batch of 20 at 0 "
              f"dB: K1/K2 at (T, R) = ({shape[1]}, {shape[0] * shape[2]}) and "
              f"{'K3' if bipolar else 'the raster pack + K5'} at (B, T, C, N) = {shape} == the plain path's, count by "
              f"count ({n_sp} spikes), DoAs equal; launches {out['launches'][name]}", flush=True)
        del demo_s, host, tables, card_tables

    # ---- multiband_speech: one band against three, and the cross-segment calibration
    demos, out["s"]["multiband designs"] = synced(
        torch, dev, lambda: tuple(mbs.build_demo(bands, 112, 1.0, dev) for bands in (mbs.SINGLE_BAND, mbs.THREE_BANDS)))
    res, out["launches"]["multiband_speech"] = counted(
        torch, _build, "multiband_speech", XYLO_PATH, lambda: mbs.run(num_sims=MB_TRIALS, demos=demos), out["s"])
    xres, out["launches"]["multiband_speech --cross-segment"] = counted(
        torch, _build, "multiband_speech --cross-segment", XYLO_PATH,
        lambda: mbs.run_cross_segment(num_sims=MB_TRIALS, demo=demos[1]), out["s"])
    cols = {f"single/{k[:-8]}": v for k, v in res["single_band_1000_2000"].items()}
    cols.update({f"three/{k[:-8]}": v for k, v in res["three_band_500_3000"].items() if k.endswith("_mae_deg")})
    cols.update({f"cross/{k[:-8]}": v for k, v in xres.items() if k.endswith("_mae_deg")})
    gate_columns(problems, "multiband_speech", cols, JAX_MB_SPEECH, JAX_MB_SPEECH_SD, MB_TRIALS, GRID_STEP_112)
    host3 = mbs.build_demo(mbs.THREE_BANDS, 112, 1.0, cpu)
    same_xylo_design(demos[1], host3, "multiband_speech three bands")
    card_tables = mbs.speech_tables(demos[1], t_sp, s_sp, stacked=True)
    tables3 = {True: card_tables, False: tuple(p.cpu() for p in card_tables)}  # keyed by "on the card"
    shape, n_sp, out["kernel_times"]["multiband_speech"] = batch_against_plain(
        torch, sk, lk, roofline, "multiband_speech three bands", demos[1], host3, trial_frames(demos[1], 16, 0.0),
        peaks_per_s, lambda d, rate: mbs.doas_from_rate(d, rate, *tables3[d is demos[1]]))
    out["shapes"]["multiband_speech"] = shape
    out["multiband"], out["cross"] = res, xres
    print(f"{tag} multiband_speech ({MB_TRIALS} trials, grid 112, 1.0 s; JAX's harness at seeds 0 / 1 in brackets, "
          f"gated as run_speech's): "
          + "; ".join(f"{k} {v} [{JAX_MB_SPEECH[0][k]} / {JAX_MB_SPEECH[1][k]}]" for k, v in cols.items())
          + f"; one three-band batch of 16 at 0 dB on the CPU twin of the card's design: K1/K2 at (T, R) = "
          f"({shape[1]}, {shape[0] * shape[2]}) and K3 at (B, T, C, N) = {shape} == the plain path's, count by count "
          f"({n_sp} spikes), the eight estimators' DoAs equal; launches {out['launches']['multiband_speech']}, "
          f"cross-segment {out['launches']['multiband_speech --cross-segment']}", flush=True)
    del demos, host3, tables3, card_tables

    # ---- xylo_ordering_sensitivity --speech (the simulator: a host-bound loop), then its frames on the CPU twin
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        ores, out["launches"]["ordering --speech"] = counted(
            torch, _build, "xylo_ordering_sensitivity --speech", ("rzcc_k1", "rzcc_k2"),
            lambda: xos.main(ORDERING_ARGV + ["--device", dev.type]), out["s"])
    got = {k: v["10.0"][0] for k, v in ores["mae_by_variant"].items()}
    if sorted(got) != sorted(JAX_ORDERING):
        problems.append(f"xylo_ordering_sensitivity --speech: conventions {sorted(got)}, JAX's {sorted(JAX_ORDERING)}")
    t0 = time.perf_counter()
    demo_o, host_o = (xos.build_demo(ORDERING_GRID, ORDERING_SEC, d) for d in (dev, cpu))  # the harness's design
    same_xylo_design(demo_o, host_o, "xylo_ordering_sensitivity --speech")
    doa_o, (frames_o,) = xos.trial_frames(demo_o, ORDERING_SIMS, [10.0], True, ORDERING_SEC)
    tw = twin_counts(torch, "xylo_ordering_sensitivity --speech", demo_o, host_o, frames_o, lif=False)
    spikes_card = demo_o.raster(tw.kp, tw.kn).to(torch.int32).transpose(0, 1)
    spikes_host = host_o.raster(tw.host_kp, tw.host_kn).to(torch.int32).transpose(0, 1)
    for ordering, reset in txl.VARIANTS:
        variant = f"{ordering}/{reset}"
        est = xos.simulate(demo_o, spikes_card, ordering, reset)[1]
        est_host = xos.simulate(host_o, spikes_host, ordering, reset)[1]
        if not np.array_equal(est, est_host):
            fail(f"xylo_ordering_sensitivity --speech {variant}: the card's DoAs differ from the CPU twin's on trials "
                 f"{np.flatnonzero(est != est_host).tolist()}")
        if float(np.mean(xos.angular_err_deg(est, doa_o))) != got[variant]:
            fail(f"xylo_ordering_sensitivity --speech {variant}: the harness's MAE {got[variant]} is not that of "
                 "its frames' DoAs")
    out["s"]["ordering CPU twin"] = time.perf_counter() - t0
    B, T, C, _ = tw.shape
    out["shapes"]["ordering --speech"] = tw.shape
    out["ordering"] = ores
    print(f"{tag} xylo_ordering_sensitivity --speech ({ORDERING_SIMS} trials at 10 dB, grid {ORDERING_GRID}, "
          f"{ORDERING_SEC} s): MAE deg {json.dumps({k: round(v, 3) for k, v in got.items()})} (JAX's harness "
          f"{json.dumps(JAX_ORDERING)}, printed); worst delta {ores['worst_delta_deg']:.3f} deg; on the CPU twin of "
          f"the card's design ({out['s']['ordering CPU twin']:.1f} s): K1/K2 at (T, R) = ({T}, {B * C}) == the plain "
          f"path's and every convention's DoAs equal, trial by trial; launches {out['launches']['ordering --speech']}",
          flush=True)
    del demo_o, host_o

    # ---- short_hilbert_transform
    sres, out["s"]["short_hilbert_transform"] = synced(torch, dev, lambda: stht_h.run(dev))
    for d, (mean, mx) in JAX_STHT.items():
        r = sres["stht_vs_hilbert"][d]
        if abs(r["rel_err_mean"] - mean) > STHT_TOL or abs(r["rel_err_max"] - mx) > STHT_TOL:
            problems.append(f"short_hilbert_transform {d}: {r}; JAX's ({mean}, {mx}) (gate {STHT_TOL} absolute)")
    if sres["rzcc_timing"]["num_pos_spikes"] != JAX_STHT_SPIKES:
        problems.append(f"short_hilbert_transform: {sres['rzcc_timing']['num_pos_spikes']} RZCC spikes, JAX's "
                        f"{JAX_STHT_SPIKES}")
    out["stht"] = sres
    print(f"{tag} short_hilbert_transform: {json.dumps(sres)} (gate: within {STHT_TOL} of JAX's, spikes equal)",
          flush=True)

    # ---- one stream through the single-stream path: three chunks, the card against the plain step
    sl = StreamingLocalizer(demo)
    state, pstate = sl.init_state(), sl.init_state()
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    spikes = []
    for k in range(3):
        state, sp = sl.process_chunk(state, frames[k])
        spikes.append(sp)
    torch.cuda.synchronize()
    out["launches"]["single stream"] = dict(_build.launch_counts)
    missing = [k for k in STREAM_PATH if out["launches"]["single stream"].get(k, 0) < 1]
    if missing:
        fail(f"single stream: {missing} never launched ({out['launches']['single stream']})")
    for k in range(3):
        pstate, psp = plain_step(torch, sk, lk, sl, pstate, frames[k][None])
        bad = mismatches(spikes[k], psp[:, 0])
        if bad:
            fail(f"single stream: chunk {k}'s raster differs from the plain step's in {bad} entries")
    bad = sum(mismatches(getattr(state, f), getattr(pstate, f)) for f in ("counts", "isyn", "vmem", "spk", "steps"))
    if bad:
        fail(f"single stream: the carried counts and LIF state differ from the plain step's in {bad} entries")
    print(f"{tag} single stream (3 chunks of {frames.shape[1]} samples, a batch of one through K1, K2, the pack and K4): "
          f"rasters, counts and LIF state == the plain step's ({int(state.counts.sum())} hidden spikes); launches "
          f"{out['launches']['single stream']}", flush=True)

    out["phase_s"] = time.perf_counter() - t_phase
    if saved_cache is None:
        os.environ.pop("HM2024_TORCH_CACHE", None)
    else:
        os.environ["HM2024_TORCH_CACHE"] = saved_cache
    tmp.cleanup()
    if problems:
        fail("phase 24's accuracy gates: " + " | ".join(problems))
    return out


# ------------------------------------------------------------------ phase 25
# the accuracy each demo's JAX test asks for (tests/test_io_demos.py: Hilbert and MUSIC 6 deg, SNN 8, SRP
# 5), by the folded metric arcsin|sin(est - true)| in degrees
DEMO_GATE_DEG = {"hilbert": 6.0, "snn": 8.0, "music": 6.0, "srp": 5.0}
# JAX's Xylo demo test asks only for a finite DoA.  The reference's unipolar model with its peak estimator
# is 8-18 deg off this tone (folded): JAX's run_demo() prints these DoAs today, on the CPU,
#   JAX_PLATFORMS=cpu HM2024_JAX_CACHE=0 HM2024_TPU_CACHE=<tmp dir> python -c \
#       "from haghighatshoarmuir2024_tpu.demos import localization_demo_xylo as m; print(m.run_demo())"
# and the port's CPU path gives them too; the card is held to one step of the 224-point grid of them
JAX_XYLO_DEMO_DEG = [-121.8834143425569, -131.56951051022708, -128.34081178767036, -121.8834143425569]
GRID_STEP_224_DEG = 360.0 / 223
DEMO_FRAMES = {"hilbert": 8, "snn": 8, "music": 8, "srp": 8, "xylo": 4}  # each run_demo's default
DEMO_DOA, DEMO_SNR_DB = 0.7, 10.0  # run_demo's defaults
DEMO_TWIN_FRAMES = 2  # frames of each demo also through the CPU path
# a card/CPU DoA mismatch passes only where the CPU path's estimator score has a relative top-two gap below
# this (a near tie); the Xylo demo's integer counts leave no tie: its DoAs must be equal
DEMO_TIE_RTOL = 1e-5
FRAME_MS = 250.0  # the demos' frame: a live demo handles a frame in less
# the most active bins the MUSIC demo's band allows at nfft 2048 (1200-2000 Hz / 23.4 Hz a bin): the
# reference's default of 100 raises ValueError in MUSIC.beamforming, in JAX's demo and in the port's alike
MUSIC_DEMO_BINS = int((2000.0 - 1200.0) / (48_000 / 2048))
XYLO_DEMO_PATH = ("rzcc_k1", "rzcc_k2", "lif_pack_raster", "lif_k5")
TRACE_KERNELS = {"rzcc_k1_kernel": "K1", "rzcc_k2_kernel": "K2", "lif_pack_bipolar_kernel": "pack",
                 "lif_count_bipolar_kernel": "K3"}


def demo_scores(torch, name, d, frame):
    """The score (G',) whose argmax the demo ``d``'s estimator takes on one
    frame: the band power of the Hilbert and SNN demos, the moving average
    the peak estimator of the MUSIC and SRP demos smooths the spectrum by."""
    from haghighatshoarmuir2024_tpu_torch.demos.localization_demo import to_device
    from haghighatshoarmuir2024_tpu_torch.ops.fir import moving_average_full

    if name in ("hilbert", "snn"):
        return d.power(frame)
    x = to_device(frame, d.device)
    aps = d.music.beamforming(x, d.num_active_freq, d.num_fft_bin) if name == "music" else d.srp.apply_to_signal(x)
    win = max(1, 2 * ((len(d.doa_list) // 32) // 2) + 1)
    return moving_average_full(aps, win) if win > 1 else aps


def classical_twin(d, cpu):
    """The Hilbert or SNN demo ``d`` on the CPU with the card's designs."""
    import copy

    twin = copy.copy(d)
    twin.device = cpu
    twin.beamfs = [copy.copy(bf) for bf in d.beamfs]
    for bf in twin.beamfs:
        bf.device = cpu
    twin.bf_mats = [m.cpu() for m in d.bf_mats]
    return twin


def twin_doas(torch, name, d, twin, frames, card_deg):
    """The CPU twin's DoAs (degrees) on ``frames`` against the card's
    ``card_deg``: equal, or (not for the Xylo demo) a near tie of the CPU
    path's score, returned as (frame, relative gap)."""
    ties = []
    for k, f in enumerate(frames):
        got = float(np.rad2deg(twin.process_frame(f)))
        if got == card_deg[k]:
            continue
        if name == "xylo":
            fail(f"xylo demo: frame {k}: the card's DoA {card_deg[k]:.4f} deg, the CPU path's {got:.4f} deg")
        gap = float(top_two_margin(demo_scores(torch, name, twin, f).cpu()[None])[0])
        if gap >= DEMO_TIE_RTOL:
            fail(f"{name} demo: frame {k}: the card's DoA {card_deg[k]:.4f} deg, the CPU path's {got:.4f} deg "
                 f"(the CPU score's top-two gap {gap:.3e}, not a near tie below {DEMO_TIE_RTOL})")
        ties.append((k, gap))
    return ties


def check_demos(torch, _build, dev, flagship_demo, frames, event_ms, attribution_ms, batch_ms):
    """Phase 25: the five live demos at their reference defaults, a wav
    file through two of them, the stage timer, a device trace, the
    benchmark helper and ``chunked_vmap`` on the card (module docstring)."""
    import itertools
    import tempfile

    from scipy.io import wavfile

    from haghighatshoarmuir2024_tpu_torch import CenterCircularArray
    from haghighatshoarmuir2024_tpu_torch.demos import localization_demo as hd
    from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_music as md
    from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_snn as nd
    from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_srp as rd
    from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_xylo as xd
    from haghighatshoarmuir2024_tpu_torch.io import FileAudioSource
    from haghighatshoarmuir2024_tpu_torch.ops import chunked_vmap
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel
    from haghighatshoarmuir2024_tpu_torch.utils import benchmark_fn, device_trace

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    tag = "[demos]"
    out = {"demos": {}, "launches": {}, "s": {}}
    tmp = tempfile.TemporaryDirectory()
    saved_cache = os.environ.get("HM2024_TORCH_CACHE")
    os.environ["HM2024_TORCH_CACHE"] = os.path.join(tmp.name, "cache")  # the Xylo demo designs on the card
    try:
        # ---- MUSIC at the reference's 100 active bins: both packages' MUSIC.beamforming refuses them
        try:
            md.run_demo(num_frames=1, device=dev)
        except ValueError as e:
            out["music_default"] = str(e)
        else:
            fail("music demo: run_demo() at 100 active bins ran; JAX's raises ValueError there")

        def build(name):
            n = DEMO_FRAMES[name]
            if name != "music":
                return {"hilbert": hd, "snn": nd, "srp": rd, "xylo": xd}[name].reference_demo(
                    n, DEMO_SNR_DB, DEMO_DOA, device=dev)
            geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
            return md.Demo(geo, [1200.0, 2000.0], np.linspace(-np.pi, np.pi, 224), num_active_freq=MUSIC_DEMO_BINS,
                           source=hd.tone_source(geo, n, DEMO_SNR_DB, DEMO_DOA, delay_sign=-1), device=dev)

        demos, twins = {}, {}
        for name in ("hilbert", "snn", "music", "srp", "xylo"):
            n = DEMO_FRAMES[name]
            d, design_s = synced(torch, dev, lambda: build(name))
            est, launches = counted(torch, _build, f"{name} demo", XYLO_DEMO_PATH if name == "xylo" else (),
                                    lambda: d.run(n))
            if name == "xylo":  # each kernel once a frame, K2 at least once (once a suppression round)
                for k in XYLO_DEMO_PATH:
                    if launches.get(k, 0) < n or (k != "rzcc_k2" and launches[k] != n):
                        fail(f"xylo demo: {k} launched {launches.get(k, 0)} times for {n} frames")
                out["launches"]["live demo xylo"] = launches
            elif launches:
                fail(f"{name} demo: launched {launches}; its path runs no hand kernel")
            est = np.asarray(est)
            err = folded_deg(np.deg2rad(est), DEMO_DOA)
            if name == "xylo":
                jax_deg = np.asarray(JAX_XYLO_DEMO_DEG[:n])
                off, gate = wrapped_deg(np.deg2rad(est), np.deg2rad(jax_deg)), GRID_STEP_224_DEG + 5e-4
                gate_text = f"within {GRID_STEP_224_DEG:.2f} deg of JAX's run_demo() {np.round(jax_deg, 3).tolist()}"
            else:
                off, gate = err, DEMO_GATE_DEG[name]
                gate_text = f"folded error at most {gate:.2f}"
            if est.shape != (n,) or not np.all(np.isfinite(est)) or off.max() > gate:
                fail(f"{name} demo: DoAs {est.tolist()} deg, folded errors {np.round(err, 3).tolist()} deg (gate: "
                     f"{gate_text})")
            rep = d.timer.report()
            compute = d.timer.samples["compute"]
            ms = 1e3 * float(np.median(compute[1:]))
            share = rep["compute"]["total_s"] / sum(v["total_s"] for v in rep.values())

            # the same frames through the port's CPU path, on the card's design
            t0 = time.perf_counter()
            if name in ("hilbert", "snn"):
                twin = classical_twin(d, cpu)
            elif name == "xylo":
                twin = xd.reference_demo(n, DEMO_SNR_DB, DEMO_DOA, device=cpu)  # the card's design, from the cache
                same_xylo_design(d.xylo, twin.xylo, "xylo demo")
            else:
                twin = (md.Demo(d.music.geometry, [1200.0, 2000.0], d.doa_list, num_active_freq=MUSIC_DEMO_BINS,
                                device=cpu) if name == "music"
                        else rd.Demo(d.srp.geometry, [1400.0, 2100.0], d.doa_list, device=cpu))
            src_frames = list(itertools.islice(d.source.frames(FRAME_MS / 1e3), DEMO_TWIN_FRAMES))
            ties = twin_doas(torch, name, d, twin, src_frames, est)
            out["s"][f"{name} cpu twin"] = time.perf_counter() - t0
            demos[name], twins[name] = d, twin
            out["demos"][name] = dict(ms=ms, rtf=ms / FRAME_MS, design_s=design_s, doas=est.tolist(),
                                      err_max=float(err.max()), compute_share=share, report=rep, ties=ties)
            bins = f"; {MUSIC_DEMO_BINS} active bins" if name == "music" else ""
            print(f"{tag} {name} ({n} frames, run_demo's defaults{bins}): DoAs {np.round(est, 3).tolist()} deg, "
                  f"folded error at most {err.max():.3f} deg (gate: {gate_text}); {ms:.3f} ms a frame (median of the frames after the first, host "
                  f"clock, synchronized) = real-time factor {ms / FRAME_MS:.4f}; design {design_s:.3f} s; the "
                  f"first {DEMO_TWIN_FRAMES} frames through the CPU path == the card's"
                  + (f" but near ties {ties}" if ties else "") + f"; stage report {json.dumps(rep)}; compute "
                  f"{100 * share:.1f} % of the loop" + ("" if share >= 0.9 else " (below 90 %: the loop's host work)"),
                  flush=True)

        # ---- the Xylo demo: its counts on one frame against the plain path; a silent frame launches nothing
        xdemo, xtwin = demos["xylo"], twins["xylo"]
        f0 = next(xdemo.source.frames(0.25))
        cs = xdemo.xylo.encode(hd.to_device(f0, dev)[None])
        card_counts = lif_kernel.lif_count_rates(xdemo.xylo.lif_params(), xdemo.xylo.raster(*xdemo.xylo.rzcc(cs)),
                                                 time_major=True, spike_bound=1).cpu()
        tw = xtwin.xylo
        host_counts = lif_kernel.lif_count_rates(tw.lif_params(), tw.raster(*tw.rzcc(cs.cpu())), time_major=True,
                                                 spike_bound=1)
        if card_counts.shape != host_counts.shape or not torch.equal(card_counts, host_counts):
            fail(f"xylo demo: the counts {tuple(card_counts.shape)} of frame 0 differ from the plain path's")
        silent, silent_launches = counted(torch, _build, "xylo demo silent frame", (),
                                          lambda: xdemo.process_frame(np.zeros_like(f0)))
        if not np.isnan(silent) or silent_launches:
            fail(f"xylo demo: a silent frame gave {silent} with launches {silent_launches}; want NaN and none")
        print(f"{tag} xylo: frame 0's counts (B, N) = {tuple(host_counts.shape)} through K1 -> K2 -> raster pack "
              f"-> K5 == the plain path's, count by count ({int(host_counts.sum())} spikes); a silent frame: NaN, "
              "no launch", flush=True)

        # ---- a 16-bit 7-channel wav of the Xylo demo's synthetic frames through the Xylo and SRP demos
        T = f0.shape[0]
        sig = xdemo.source._sig[:DEMO_TWIN_FRAMES * T]
        path = os.path.join(tmp.name, "demo.wav")
        wavfile.write(path, 48_000, np.round(sig * (0.9 / np.abs(sig).max()) * 32767).astype(np.int16))
        wav = {}
        for name in ("xylo", "srp"):
            d = demos[name]
            d.source = FileAudioSource(path)
            est, launches = counted(torch, _build, f"{name} demo on the wav",
                                    XYLO_DEMO_PATH if name == "xylo" else (), lambda: d.run(DEMO_TWIN_FRAMES))
            dec = list(FileAudioSource(path).frames(0.25))
            ties = twin_doas(torch, name, d, twins[name], dec, est)
            wav[name] = dict(doas=est, ties=ties, launches=launches)
        out["wav"] = wav
        print(f"{tag} the wav ({DEMO_TWIN_FRAMES} frames of the Xylo demo's source, int16, 7 channels) through "
              "FileAudioSource: " + ", ".join(f"{k} DoAs {np.round(v['doas'], 3).tolist()} deg" for k, v in wav.items())
              + " == the CPU path's on the decoded frames"
              + "".join(f"; {k} near ties {v['ties']}" for k, v in wav.items() if v["ties"]), flush=True)

        # ---- device_trace around one flagship forward_batch(matched)
        trace_dir = os.path.join(tmp.name, "trace")
        torch.cuda.synchronize()
        with device_trace(trace_dir):
            flagship_demo.forward_batch(frames, method="matched")
            torch.cuda.synchronize()
        files = sorted(Path(trace_dir).glob("*.json"))
        if not files:
            fail("device_trace wrote no trace file")
        events = json.loads(files[0].read_text())["traceEvents"]
        kern = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
        if not kern:
            fail("device_trace recorded no CUDA kernel: the profiler's CUPTI activity tracing is not available here")
        traced = {}
        for kname, label in TRACE_KERNELS.items():
            ev = [e for e in kern if kname in e.get("name", "")]
            if not ev:
                fail(f"device_trace: no event of {kname} ({label}) among {len(kern)} kernel events")
            traced[label] = [e["dur"] / 1e3 for e in ev]
        out["trace"] = dict(file_bytes=files[0].stat().st_size, kernels=len(kern), traced_ms=traced)
        print(f"{tag} device_trace of forward_batch(matched) at B = {frames.shape[0]}: {files[0].name} "
              f"({files[0].stat().st_size} bytes, {len(kern)} kernel events); traced per launch: "
              + ", ".join(f"{k} {np.round(v, 4).tolist()} ms" for k, v in traced.items())
              + "; CUDA events of phases 3-4: " + ", ".join(f"{k} {v:.4f} ms" for k, v in event_ms.items()),
              flush=True)

        # ---- benchmark_fn on the same call
        bench = benchmark_fn(lambda: flagship_demo.forward_batch(frames, method="matched"), warmup=2, iters=20)
        out["bench"] = bench
        print(f"{tag} benchmark_fn(forward_batch(matched), 20 iterations): {bench['mean_ms']:.3f} ms a call; "
              f"phase 23's attribution total {attribution_ms:.3f} ms (CUDA events); the host-clock batch time "
              f"{batch_ms:.3f} ms", flush=True)

        # ---- chunked_vmap on CUDA tensors: 449 rows in chunks of 64 (the last of one row) == vmap of the whole
        g = torch.Generator(dev).manual_seed(SEED)
        x = torch.randint(-1000, 1000, (449, 14, 7), generator=g, device=dev)
        w = torch.randint(-9, 9, (449, 3), generator=g, device=dev)
        fn = lambda t: (t[0] * t[1]["w"].sum(), {"max": t[0].amax(dim=-1), "sum": t[0].sum()})  # noqa: E731
        got, want = chunked_vmap(fn, (x, {"w": w}), 64), torch.func.vmap(fn)((x, {"w": w}))
        pairs = [(got[0], want[0]), (got[1]["max"], want[1]["max"]), (got[1]["sum"], want[1]["sum"])]
        if not all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs):
            fail("chunked_vmap on the card differs from vmap of the whole input")
        print(f"{tag} chunked_vmap (449 rows, chunks of 64, pytree in and out) == torch.func.vmap of the whole "
              "input, exactly", flush=True)
    finally:
        if saved_cache is None:
            os.environ.pop("HM2024_TORCH_CACHE", None)
        else:
            os.environ["HM2024_TORCH_CACHE"] = saved_cache
        tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def sweep_label(name: str) -> str:
    return name if name.startswith("srp") else f"{name} tone"


def speech_srp(srp_h, G, dev):
    """SRP-PHAT's speech localizer and template, as ``mc_sweep``'s leading
    arguments (profile, grid, geometry, t, sig)."""
    srp, (t, sig) = srp_h.build("speech", G, speech_duration=SPEECH_SEC, device=dev)
    return srp.apply_to_signal, srp.doa_list, srp.geometry, t, sig


def min_unit_phase_cos(got, want, fold: bool = False) -> float:
    """The least ``|<want_g, got_g>|`` over the columns of two designs:
    complex (M, G), or 2M-real re-folded with ``fold``."""
    if fold:
        got, want = complex_cols(got), complex_cols(want)
    return float(np.abs(np.sum(np.conj(want) * got, axis=0)).min())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs only on the GPU", file=sys.stderr)
        return 1
    start = time.perf_counter()
    repo = Path(__file__).resolve().parent
    if not (repo / "haghighatshoarmuir2024_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (port package not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))

    # ---- phase 1: device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {so.name} in {build_s:.1f} s", flush=True)
    for ln in ptxas:
        print(f"[build] {ln}")
    lap(start, "build")

    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo, XyloConfig
    from haghighatshoarmuir2024_tpu_torch.models.xylo import multiband as mb
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import FRAME, GRID, flagship_config, flagship_frames
    from haghighatshoarmuir2024_tpu_torch.ops import peaks
    from haghighatshoarmuir2024_tpu_torch.experiments import multiband_bench, roofline
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel as lk
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import roofline_kernel as rk
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk
    from haghighatshoarmuir2024_tpu_torch.ops import mulaw, resample
    from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer, server

    # the flagship: bench.py's config and frames
    frame, B, G = FRAME, 96, GRID
    flagship = flagship_config(dev)
    demo = Demo(**flagship)  # the bundled design
    demo.calibrate_profiles()  # the bundled table
    frames, doas = flagship_frames(demo, B, seed=SEED)
    T = frames.shape[1]

    cs = demo.encode(frames)  # (T, B, C)
    C = cs.shape[-1]
    if not bool(torch.isfinite(cs).all()):
        fail("encode produced non-finite values")

    # ---- phase 3: K1/K2
    sup = check_suppress(torch, sk, peaks, dev, cs.reshape(T, B * C))
    lap(start, "flagship set up, K1/K2")

    # ---- phase 4: K3
    kp, kn = demo.rzcc(cs)
    lif, pack = check_lif(torch, lk, XyloConfig, dev, demo.xylo_config, (kp, kn))
    lap(start, "K3")

    # ---- phase 5: the slice through the user's entry point
    demo.forward_batch(frames, method="matched")  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    doa, rate = demo.forward_batch(frames, method="matched")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    for name in ("rzcc_k1", "rzcc_k2", "lif_pack", "lif_k3"):
        if launches.get(name, 0) < 1:
            fail(f"the slice run never launched {name} (launch counts {launches})")
    if doa.shape != (B,) or rate.shape != (B, G) or not bool(torch.isfinite(rate).all()):
        fail(f"slice output malformed: doa {tuple(doa.shape)}, rate {tuple(rate.shape)}")

    # the plain path on the same frames and card: encode, plain RZCC, plain LIF
    p_kp, p_kn = sk.rzcc_encode_bipolar_tm_plain(cs.reshape(T, B * C), demo.robust_width,
                                                 2 * demo.robust_width)
    p_counts = lk.lif_count_plain(demo.xylo_config, p_kp.reshape(T, B, C), p_kn.reshape(T, B, C))
    p_doa, p_rate = demo.estimate(p_counts, T, "matched")
    if not torch.equal(doa, p_doa) or not torch.equal(rate, p_rate):
        fail("slice DoAs/rates differ from the plain path's")

    doa_np = doa.cpu().numpy()
    peak_np = demo.doa_list[rate.argmax(dim=-1).cpu().numpy()]
    ok_matched, ok_peak = ok_frac(doa_np, doas, 5.0), ok_frac(peak_np, doas, 25.0)
    print(f"[slice] B={B} T={T}: launches {launches}; DoAs identical to the plain path; "
          f"doa-ok-frac {ok_matched:.2f} @5deg (matched), {ok_peak:.2f} @25deg (reference-parity peak)",
          flush=True)
    if ok_matched < 1.0:
        fail(f"matched accuracy gate failed: doa-ok-frac {ok_matched:.2f} @5deg")

    # ---- phases 6-8: K4, the streaming runtime, the serving daemon
    lap(start, "the bipolar batch")
    lif4 = check_lif_stateful(torch, lk, XyloConfig, dev, demo.xylo_config, (kp, kn))
    lap(start, "K4")
    stream_launches, stream = check_streaming(torch, sk, lk, _build, StreamingLocalizer, demo, frames, doas)
    lap(start, "bipolar streaming")
    serve = check_serving(torch, _build, StreamingLocalizer, server, resample, mulaw, demo, frames, n_chunks=8)
    lap(start, "serving")

    # ---- phases 9-14: the design path, the unipolar model, K5 and K6
    design = check_design(torch, Demo, flagship, demo, frames, doas)
    lap(start, "design")
    udemo, uni = check_unipolar(torch, sk, lk, _build, Demo, flagship, frames, doas)
    lap(start, "the unipolar batch")
    u_kp, _ = udemo.rzcc(udemo.encode(frames))
    u_spikes = u_kp.to(torch.int8)
    b_kp, b_kn = kp[:, :1], kn[:, :1]
    b_spikes = torch.cat([b_kp & ~b_kn, b_kn], dim=-1).to(torch.int8)  # (T, 1, 2C)
    k5, rpack = check_k5(torch, lk, XyloConfig, dev, udemo.xylo_config, u_spikes, demo.xylo_config, b_spikes,
                         (kp, kn))
    lap(start, "K5")
    fwd = check_forward(torch, _build, {"bipolar": demo, "unipolar": udemo}, frames)
    k6 = check_k6(torch, lk, XyloConfig, dev, udemo.xylo_config, u_spikes)
    lap(start, "Demo.forward, K6")
    ustream_launches, ustream = check_streaming_unipolar(torch, sk, lk, _build, StreamingLocalizer, udemo,
                                                         frames, doas)

    lap(start, "unipolar streaming")
    # ---- phases 15-17: K7, the roofline probes, the harness's measurements
    k7_launches, k7 = check_k7(torch, sk, peaks, _build, dev, cs.reshape(T, B * C),
                               (kp.reshape(T, B * C), kn.reshape(T, B * C)))
    check_probes(torch, rk, lk, dev, demo.xylo_config, (kp, kn))
    w, W = sk._windows(demo.robust_width, 2 * demo.robust_width)
    rf_launches, rf = run_roofline(torch, roofline, _build, demo.xylo_config, (kp, kn), w, card)
    lap(start, "K7, the probes, the roofline harness")

    # ---- phases 18-19: the 24 kHz mode; the three-band model at 48 and 24 kHz
    r24 = check_24k(torch, sk, lk, _build, Demo, StreamingLocalizer, resample, flagship, frames, doas)
    lap(start, "24 kHz")
    three = {}
    for fs in (48_000, 24_000):
        three[fs] = check_multiband(torch, sk, lk, _build, Demo, StreamingLocalizer, server, resample, mulaw,
                                    roofline, mb, multiband_bench, dev, fs, rf["ceil"]["peaks"], serve=fs == 48_000)
        lap(start, f"three bands at {fs // 1000} kHz")

    # stage and end-to-end times
    stage_ms = {
        "encode": timed_ms(torch, lambda: demo.encode(frames), 10),
        "rzcc (K1+K2)": sup["rzcc_ms"],
        "lif (pack + K3)": lif["ms"],
        "estimate": timed_ms(torch, lambda: demo.estimate(p_counts, T, "matched"), 20),
    }
    batch_ms = host_ms(torch, lambda: demo.forward_batch(frames, method="matched"), 20)
    ubatch_ms = host_ms(torch, lambda: udemo.forward_batch(frames, method="matched"), 20)

    # ---- phase 20: the classical families, the localizer, multi-source serving; after the
    # main path's times, which its CPU-path comparisons and its daemon would otherwise precede
    fam = check_families(torch, _build, server, StreamingLocalizer, demo, frames, doas, dev)
    lap(start, "the classical families and the localizer")
    # ---- phase 21: the simulator, the stage API, push-to-hidden, the MC accuracy harness
    xy = check_xylo(torch, _build, Demo, flagship, demo, frames, dev)
    lap(start, "the Xylo simulator, push-to-hidden and the MC harness")
    # ---- phase 22: the accuracy, beam-pattern, multi-target and robustness harnesses
    hx = check_harnesses(torch, _build, dev)
    lap(start, "the accuracy, beam-pattern, multi-target and robustness harnesses")
    # ---- phase 23: the harnesses that time and check the ported paths, and the reverberant room
    bx = check_bench_harnesses(torch, _build, sk, lk, StreamingLocalizer, dev, demo, frames, doas, doa)
    lap(start, "the harnesses that time and check the ported paths")
    # ---- phase 24: the speech harnesses, the STHT analysis and one stream through the single-stream path
    spx = check_speech_harnesses(torch, _build, sk, lk, roofline, StreamingLocalizer, dev, demo, frames,
                                 rf["ceil"]["peaks"])
    lap(start, "the speech harnesses, the STHT analysis and the single stream")
    # ---- phase 25: the live demos, a wav through two of them, profiling and batching helpers
    dx = check_demos(torch, _build, dev, demo, frames,
                     {"K1": sup["k1"]["ms"], "K2 (one launch)": sup["k2"]["ms"], "pack": pack["ms"],
                      "pack + K3 (integers uploaded once)": lif["params_ms"]},
                     bx["attribution"]["stages_ms"]["TOTAL (matched)"], batch_ms)
    lap(start, "the live demos, profiling and batching")
    tag = f"[times] [{card}]"  # every time line names the card and its power limit
    for name, ms in stage_ms.items():
        print(f"{tag} stage {name}: {ms:.3f} ms")
    print(f"{tag} rzcc plain (torch ops on the card): {sup['rzcc_plain_ms']:.3f} ms")
    for name, k in (("K1", sup["k1"]), ("K2", sup["k2"]), ("pack", pack), ("K3 (pack included)", lif),
                    ("K4 (pack included)", lif4), ("raster pack", rpack), ("K5 (raster pack included)", k5),
                    ("K6 (raster pack included)", k6), ("K7", k7)):
        print(f"{tag} kernel {name}: {k['ms']:.3f} ms vs plain {k['plain_ms']:.3f} ms"
              + (f" (the LIF integers uploaded once: {k['params_ms']:.3f} ms)" if "params_ms" in k else "")
              + (f" (the launch alone, outputs allocated once: {k['raw_ms']:.3f} ms)" if "raw_ms" in k else "")
              + (f" (one PyTorch call of the same function: {k['library_ms']:.3f} ms)" if "library_ms" in k else ""))
    print(f"{tag} K3 with the LIF integers uploaded once: flagship masks {lif['params_ms']:.3f} ms; the same "
          f"with six set bits a chunk of {CHAIN_STAGE} (six slots read in every chunk) {lif['six_ms']:.3f} ms")
    print(f"{tag} K5 with the LIF integers uploaded once: unipolar flagship masks as int8 {k5['params_ms']:.3f} ms, "
          f"as bool {k5['bool_ms']:.3f} ms; a dense binary raster of the same size {k5['dense_binary_ms']:.3f} ms; "
          f"dense with values -8..8 (clips {'kept' if k5['dense_clip'] else 'proven dead'}) {k5['dense_ms']:.3f} ms; "
          f"the chain kernel's launch alone on the packed flagship raster {k5['chain_ms']:.3f} ms; the tensor-core "
          f"fill's own bound {roofline.raster_fill_ms(T, B, u_spikes.shape[-1], udemo.xylo_config.w_in.shape[1]):.4f} ms")
    print(f"{tag} the bipolar flagship through K5 (the combined raster of 2C = {2 * C} channels, counts == K3's): "
          f"{k5['bipolar_ms']:.3f} ms, {k5['bipolar_cat_ms']:.3f} ms with the raster made from the two masks, "
          f"against pack + K3 {lif['params_ms']:.3f} ms")
    print(f"{tag} K5 at the flagship's size by channels (int8 weights, the fragments in registers, clips proven dead; "
          f"integers uploaded once): C = {C} {k5['params_ms']:.3f} ms, {2 * C} {k5['bipolar_ms']:.3f} ms, "
          + ", ".join(f"{c} {ms:.3f} ms" for c, ms in k5["channels_ms"].items())
          + f"; the fragments read each group: two byte planes (one flagship weight set to 128; clips "
          f"{'kept' if k5['planes_clip'] else 'proven dead'}) {k5['planes_ms']:.3f} ms")
    print(f"{tag} select_by_distance_tm on the flagship maxima ({k7_launches['suppress_k7']} K7 launches): "
          f"{k7['call_ms']:.3f} ms vs plain {k7['call_plain_ms']:.3f} ms")
    print(f"{tag} forward_batch(matched) {batch_ms:.3f} ms per {B} x {frame} s batch = "
          f"{B * frame / (batch_ms / 1e3):.1f} audio-sec/sec", flush=True)
    print(f"{tag} streaming step {stream['step_ms']:.3f} ms per {B} streams x {frame} s chunk = "
          f"{B * frame / (stream['step_ms'] / 1e3):.1f} serving audio-sec/sec; single-stream latency "
          f"{stream['latency_ms']:.3f} ms (median of {LATENCY_SAMPLES}, max {stream['latency_max_ms']:.3f} ms)")
    print(f"{tag} design on the card: bipolar flagship {design['design_s']:.3f} s, unipolar flagship "
          f"{uni['design_s']:.3f} s; calibration (449 DoAs through forward_batch): bipolar "
          f"{design['calib_s']:.3f} s, unipolar {uni['calib_s']:.3f} s")
    print(f"{tag} unipolar forward_batch(matched) {ubatch_ms:.3f} ms per {B} x {frame} s batch = "
          f"{B * frame / (ubatch_ms / 1e3):.1f} audio-sec/sec; unipolar streaming step "
          f"{ustream['step_ms']:.3f} ms per {B} streams")
    for name, r in fwd.items():
        print(f"{tag} Demo.forward ({name}) single-frame latency {r['latency_ms']:.3f} ms "
              f"(median of {LATENCY_SAMPLES}, max {r['latency_max_ms']:.3f} ms)")
    for wire, r in serve.items():
        print(f"{tag} serve step ({wire} wire, {r['steps']} steps after the first round): "
              f"device {r['device_ms']:.3f} ms, "
              f"wait {r['wait_ms']:.3f} ms, route {r['route_ms']:.3f} ms per step", flush=True)
    print(f"{tag} 24 kHz (bench.py's frames decimated by 2, T = {r24['T']}): forward_batch(matched) "
          f"{r24['batch_ms']:.3f} ms per {r24['B']} x {frame} s batch = {r24['B'] * frame / (r24['batch_ms'] / 1e3):.1f} "
          f"audio-sec/sec; streaming step {r24['step_ms']:.3f} ms per {r24['B']} streams x {frame} s chunk")
    for fs, r in three.items():
        t3 = f"{tag} three bands at {fs // 1000} kHz:"
        print(f"{t3} design on the card {r['design_s']:.3f} s, calibration folded + band-stacked "
              f"{r['calib_s']:.3f} s; forward_batch(matched) {r['batch_ms']:.3f} ms, (matched_stacked) "
              f"{r['stacked_batch_ms']:.3f} ms per {B} x {frame} s batch = {B * frame / (r['batch_ms'] / 1e3):.1f} "
              f"audio-sec/sec; streaming step {r['step_ms']:.3f} ms per {B} streams x {frame} s chunk")
        print(f"{t3} K1 {r['k1_ms']:.4f} ms, K2 {r['k2_ms']:.4f} ms, pack {r['pack_ms']:.4f} ms, K3 (pack included) "
              f"{r['k3_ms']:.4f} ms (the LIF integers uploaded once: {r['k3_params_ms']:.4f} ms; plain, 32 rows at a "
              f"time {r['k3_plain_ms']:.1f} ms), K4 (pack included) {r['k4_ms']:.4f} ms (uploaded once: "
              f"{r['k4_params_ms']:.4f} ms); K5 on the combined raster (2C = 84, counts == K3's) "
              f"{r['k5_combined_ms']:.4f} ms, {r['k5_cat_ms']:.4f} ms with the raster made from the two masks")
        for name, b in r["bounds"].items():
            ms = {"rzcc_k1": r["k1_ms"], "rzcc_k2": r["k2_ms"], "lif_pack": r["pack_ms"],
                  "lif_k3": r["k3_params_ms"], "lif_k4": r["k4_params_ms"]}[name]
            print(f"{t3} bound {name}: {ms:.4f} ms against a bound of {b['bound_ms']:.4f} ms ({b['bound_by']}: "
                  f"{b['ops']:.4g} ops, {b['bytes']:.4g} bytes); the bound is {100 * b['bound_ms'] / ms:.1f} % of the "
                  "kernel's time")

    # every kernel's bound, from the harness's one table of what each kernel
    # is counted for: its least operations over the higher of the probe's
    # rate and the guide's peak, or its bytes over 3.35 TB/s, whichever is
    # larger
    ceil, p3 = rf["ceil"], rf["p3"]
    p1b, p2c = ceil["p1"]["best"], ceil["p2"]
    N = np.asarray(demo.xylo_config.w_in).shape[1]
    work = roofline.flagship_work(cs.reshape(T, B * C), w, W, kp, kn, u_spikes, N, p1b, p2c)
    bounds = roofline.bounds(work, ceil["peaks"])
    probe_res = {
        "probe_p1": dict(max_abs_err=p1b["max_abs_err"], ms=p1b["ms"], plain_ms=p1b["plain_ms"]),
        "probe_p2": dict(max_abs_err=p2c["max_abs_err"], ms=p2c["ms"], plain_ms=p2c["plain_ms"]),
        "probe_p3": dict(max_abs_err=float(p3["k4_max_abs_err"]), ms=p3["k4_ms"], plain_ms=lif["plain_ms"]),
    }

    noun = {"compares": "compares", "int32": "int32 ops"}
    kernels = []
    for name, src, repl, key, res in (
        ("rzcc_k1", "haghighatshoarmuir2024_tpu_torch/csrc/suppress.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/suppress_kernel.py:334", "rzcc_k1", sup["k1"]),
        ("rzcc_k2", "haghighatshoarmuir2024_tpu_torch/csrc/suppress.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/suppress_kernel.py:248", "rzcc_k2", sup["k2"]),
        ("lif_pack", "haghighatshoarmuir2024_tpu_torch/csrc/lif.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:300", "lif_pack", pack),
        ("lif_k3", "haghighatshoarmuir2024_tpu_torch/csrc/lif.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:275", "lif_k3", lif),
        ("lif_k4", "haghighatshoarmuir2024_tpu_torch/csrc/lif.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:468", "lif_k4", lif4),
        ("lif_pack_raster", "haghighatshoarmuir2024_tpu_torch/csrc/lif_raster.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:109", "lif_pack_raster", rpack),
        ("lif_k5", "haghighatshoarmuir2024_tpu_torch/csrc/lif_raster.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:76", "lif_k5", k5),
        ("lif_k6", "haghighatshoarmuir2024_tpu_torch/csrc/lif_raster.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:666", "lif_k6", k6),
        ("suppress_k7", "haghighatshoarmuir2024_tpu_torch/csrc/suppress.cu",
         "haghighatshoarmuir2024_tpu/ops/pallas/suppress_kernel.py:124", "suppress_k7", k7),
        ("probe_p1", "haghighatshoarmuir2024_tpu_torch/csrc/roofline.cu",
         "experiments/vpu_roofline.py:77", "probe_p1", probe_res["probe_p1"]),
        ("probe_p2", "haghighatshoarmuir2024_tpu_torch/csrc/roofline.cu",
         "experiments/vpu_roofline.py:163", "probe_p2", probe_res["probe_p2"]),
        ("probe_p3", "haghighatshoarmuir2024_tpu_torch/csrc/roofline.cu",
         "experiments/vpu_roofline.py:226", "probe_p3", probe_res["probe_p3"]),
    ):
        # launches: K1-K3 and the pack pass from the bipolar forward_batch
        # run, K4 from the bipolar streaming run, the raster pack pass and K5
        # from the unipolar forward_batch run, K6
        # from the unipolar streaming run, K7 from one select_by_distance_tm
        # call, P1-P3 from the roofline run
        path = {"lif_k4": stream_launches, "lif_pack_raster": uni["launches"], "lif_k5": uni["launches"],
                "lif_k6": ustream_launches,
                "suppress_k7": k7_launches}.get(key, rf_launches if key.startswith("probe") else launches)
        (ops, nbytes), (bound_ms, bound_by) = work[key], bounds[key]
        print(f"{tag} bound {name}: {res['ms']:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}: "
              f"{ops:.4g} {noun[roofline.UNIT[key]]}, {nbytes:.4g} bytes); the bound is "
              f"{100 * bound_ms / res['ms']:.1f} % of the kernel's time")
        # the three-band model's times and bounds of the kernels it runs with other inputs (48 kHz)
        f3 = three[48_000]
        f3_ms = {"rzcc_k1": f3["k1_ms"], "rzcc_k2": f3["k2_ms"], "lif_pack": f3["pack_ms"],
                 "lif_k3": f3["k3_params_ms"], "lif_k4": f3["k4_params_ms"]}
        extra = {} if key not in f3_ms else {"f3_ms": f3_ms[key], "f3_bound_ms": f3["bounds"][key]["bound_ms"]}
        # phase 21's paths: one MC trial batch (reference estimator) and one single-frame matched call
        extra["xylo_launches"] = {"mc_batch": xy["mc_launches"]["reference"].get(key, 0),
                                  "frame_matched": xy["frame_launches"].get(key, 0)}
        # phase 22's paths: moving_target's frames (Demo.forward) and mismatch_robustness's batches
        extra["harness_launches"] = {"moving_target": hx["moving_launches"].get(key, 0),
                                     "mismatch_robustness": hx["mismatch_launches"].get(key, 0),
                                     **{name: n.get(key, 0) for name, n in bx["launches"].items()},
                                     **{name: n.get(key, 0) for name, n in spx["launches"].items()},
                                     **{name: n.get(key, 0) for name, n in dx["launches"].items()},
                                     **{f"multiband_bench {fs // 1000} kHz": three[fs]["bench_launches"].get(key, 0)
                                        for fs in three}}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": path[key], "max_abs_err": res["max_abs_err"],
                        "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": res.get("library_ms"),
                        **{k: res[k] for k in ("params_ms", "raw_ms") if k in res}, **extra})
    for name in ("hilbert", "music", "srp"):
        f = fam[name]
        print(f"{tag} {name}: {f['frame_ms']:.3f} ms per frame in a batch of {B} ({f['batch_ms']:.1f} ms), one "
              f"frame alone {f['one_ms']:.3f} ms")
    print(f"{tag} Hilbert design on the card (449 DoAs, 0.25 s template): plain {fam['design_s']:.3f} s, "
          f"interference removal {fam['design_ir_s']:.3f} s")
    print(f"{tag} the per-sample bandpass scan of one frame (iir_filter method=scan, 12 000 steps): Hilbert "
          f"(complex, order 2) {fam['hilbert_scan_ms']:.3f} ms = {100 * fam['hilbert_scan_ms'] / fam['hilbert']['one_ms']:.1f} % "
          f"of its frame; MUSIC (real, order 1) {fam['music_scan_ms']:.3f} ms = "
          f"{100 * fam['music_scan_ms'] / fam['music']['one_ms']:.1f} % of its frame")
    print(f"{tag} localize per frame (the CLI's estimators, grid 225, B = 1): "
          + ", ".join(f"{m} {fam['cli'][m]:.3f} ms" for m in ("xylo", "hilbert", "music", "srp")))
    for label, r in xy["sim"].items():
        print(f"{tag} XyloSim {label}, record=True, B = {SIM_ROWS}, T = {T}: {r['card_s']:.3f} s a call on the card "
              f"(the CPU path {r['cpu_s']:.3f} s)")
    print(f"{tag} Xylo MC ({MC_TRIALS} trials x 11 SNRs x 2 estimators, grid 112): {xy['mc_s']:.3f} s with the "
          f"calibration; the convention envelope ({ENVELOPE_TRIALS} x 11 x 4) {xy['envelope_s']:.3f} s; the push-to-hidden check (8 trials) "
          f"{xy['p2h_check_s']:.3f} s; designs on the card {xy['mc_design_s']:.3f} s (1000-2000 Hz) and "
          f"{xy['p2h_design_s']:.3f} s (push-to-hidden); phase 21 {xy['phase_s']:.1f} s")
    for name, r in hx["sweeps"].items():
        print(f"{tag} {sweep_label(name)} sweep ({SWEEP_TRIALS} x 11, grid {HARNESS_GRID}): {r['s']:.3f} s; one {SWEEP_TRIALS}-trial "
              f"batch {1e3 * r['batch_s']:.1f} ms (least of {SHARE_REPS}) (the CPU path's comparison {r['cpu_s']:.1f} s)")
    for name, r in hx["speech"].items():
        print(f"{tag} {name} speech sweep ({SPEECH_TRIALS} trials x {len(r['mae'])} SNRs): {r['s']:.3f} s")
    for name, (scan_s, batch_s) in hx["scan_share"].items():
        print(f"{tag} {name}: the per-sample bandpass scan inside a {SWEEP_TRIALS}-trial batch {1e3 * scan_s:.1f} ms "
              f"= {100 * scan_s / batch_s:.1f} % of the batch's {1e3 * batch_s:.1f} ms (host clock, synchronized)")
    print(f"{tag} harness seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in hx["s"].items())
          + f"; phase 22 {hx['phase_s']:.1f} s")
    a = bx["attribution"]
    print(f"{tag} flagship attribution (B = {B}, CUDA events, median of {a['rounds']} rounds of {a['reps']} calls): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in a["stages_ms"].items())
          + f"; isolated RZCC {a['isolated_ms']['RZCC']:.3f} ms, LIF {a['isolated_ms']['LIF']:.3f} ms; K2 flag reads "
          f"{a['k2_flag_reads']}; spreads {json.dumps(a['spread_ms'])}")
    for label, r in bx["serving"].items():
        print(f"{tag} {label}: {json.dumps(r)}")
    for fs, r in three.items():
        print(f"{tag} multiband_bench at {fs // 1000} kHz: {r['bench']['ms_per_batch']} ms per batch, "
              f"{r['bench']['throughput_audio_sec_per_sec']} audio-sec/sec")
    for bname in ("lo", "hi"):
        for r in bx[f"reduced_rate {bname}"]["rows"]:
            print(f"{tag} reduced_rate {bname} at {r['fs'] // 1000} kHz: B = 96 forward_batch(matched) "
                  f"{r['forward_ms_b96']:.3f} ms = {r['audio_sec_per_sec']:.1f} audio-sec/sec")
    print(f"{tag} live benchmark: {bx['benchmark']['run']['collected']['audio_sec_per_sec']:.1f} audio-sec/sec over "
          f"200 frames of 0.4 s (B = 20 a batch); design_time_probe {json.dumps(bx['design_probe'])}")
    print(f"{tag} phase 23 seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in bx["s"].items())
          + f"; phase 23 {bx['phase_s']:.1f} s")
    for name, k in spx["kernel_times"].items():
        print(f"{tag} {name} at (B, T, C, N) = {spx['shapes'][name]}: K1 + K2 (one rzcc call) {k['rzcc_ms']:.4f} ms "
              f"against a bound of {k['rzcc_bound_ms']:.4f} ms; {k['lif']} {k['lif_ms']:.4f} ms against "
              f"{k['lif_bound_ms']:.4f} ms (the integers uploaded once)")
    print(f"{tag} phase 24 seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in spx["s"].items())
          + f"; phase 24 {spx['phase_s']:.1f} s")
    for name, r in dx["demos"].items():
        print(f"{tag} live demo {name}: {r['ms']:.3f} ms a frame = real-time factor {r['rtf']:.4f} "
              f"({'slower' if r['rtf'] > 1 else 'faster'} than live); design {r['design_s']:.3f} s; compute "
              f"{100 * r['compute_share']:.1f} % of the loop")
    print(f"{tag} benchmark_fn(forward_batch(matched)) {dx['bench']['mean_ms']:.3f} ms; phase 25 seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in dx["s"].items()) + f"; phase 25 {dx['phase_s']:.1f} s")
    lap(start, "the times")
    print(f"[clock] the whole script: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
