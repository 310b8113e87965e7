"""What the streaming drivers share: the streams' chunks and the check of the
carried counts against the reference."""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import check, signals
from ..reference import localizer as ref


def chunks(ctx, lanes: int, dev, gen) -> torch.Tensor:
    """(lanes, Tc, M) float32 chunks of ``lanes`` live streams on ``dev``, a
    chunk one frame of the configuration: each stream a tone of the first
    band, on the traffic's frequency step so that a chunk holds whole periods
    and the stream continues across chunks when it repeats, from a direction
    uniform on [−π, π), with white noise at an SNR uniform on ``snr_db``.
    Every period a stream sends the same chunk."""
    tr, cfg = ctx.traffic, ctx.cfg
    lo_hz, hi_hz = cfg.model["freq_bands"][0]
    step = float(tr["tone_step_hz"])
    Tc = cfg.frame_samples
    if (lo_hz * Tc / cfg.fs) % 1 or (step * Tc / cfg.fs) % 1:
        raise ValueError(f"tones on a {step} Hz step from {lo_hz} Hz hold no whole number of periods in {Tc} samples")
    n_freq = int((hi_hz - lo_hz) // step) + 1
    doa = signals.uniform(gen, lanes, -math.pi, math.pi, dev)
    snr = signals.uniform(gen, lanes, *tr["snr_db"], dev)
    freq = lo_hz + step * torch.randint(0, n_freq, (lanes,), generator=gen, device=dev).to(torch.float64)
    return signals.array_audio(signals.ArraySpec(cfg.model["array"]), {"kind": "tone"}, doa, snr, Tc, cfg.fs, gen,
                               freq_hz=freq)


def shape(ctx, sl, lanes: int) -> dict:
    """The roofline's shape of one stream step over ``lanes`` streams."""
    cfg = ctx.cfg
    M = int(cfg.model["array"]["num_mic"])
    Tc = cfg.frame_samples
    return dict(T=Tc, B=lanes, M=M, F=cfg.bands, C=2 * M * cfg.bands, N=int(sl.n_hidden),
                G=int(cfg.model["grid_points"]), K=sl.K, L=sl.guard + sl.pending + Tc, stateful=True)


def verify(ctx, host_chunks: torch.Tensor, prog_counts: np.ndarray, prog_doa: np.ndarray, dev, before: int):
    """``(checks, set input bits a step and stream)`` of the program's
    carried counts (steps, S, N) and DoAs (steps, S) after each of the
    window's first steps of S streams whose chunks are ``host_chunks``
    (S, Tc, M), the streams having taken ``before`` steps before the
    window: the reference replays every step from the streams' first."""
    t = time.perf_counter()
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    steps = before + prog_counts.shape[0]
    ref_counts, nnz = ref.stream_counts(model, host_chunks.to(dev), steps, dev)
    checks = check.stream(model, prog_counts, prog_doa, ref_counts[before:])
    print(f"[check] the reference {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    return checks, nnz / (steps * host_chunks.shape[0])


def control(ctx, host_chunks: torch.Tensor, dev) -> dict:
    """The control's numbers (``check.control_stream``) on the chunks
    (S, Tc, M) of the streams that a run of the cell checks, over the steps
    it checks."""
    tr = ctx.traffic
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    before = int(tr["steps_before_window"])
    steps = before + int(tr["check_steps"])
    want, _ = ref.stream_counts(model, host_chunks, steps, dev)
    return check.control_stream(model, host_chunks, steps, dev, want, before)
