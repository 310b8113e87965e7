"""Offline batches in a closed loop: ``Demo.forward_batch(x, "matched")`` back
to back over a pool of batches made on the card at set-up, each call's DoAs
copied to the host (into pinned memory, without a wait).  The window ends in
a synchronize.

Traffic parameters: ``batch`` frames a call, ``pool_batches`` batches in
the pool (each frame one source at a direction uniform on [−π, π) with
white noise at an SNR uniform on ``snr_db``), ``check_batches`` of them,
drawn from the seed, whose answers the reference recomputes (all in a
traced run), ``trace_seconds`` the traced window.  Reports
``audio_s_per_s``: frames × frame length over the window.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np

from .. import check, device, signals
from ..check import draw
from ..reference import localizer as ref
from ..run import Outcome
from ..system import build_demo
from ..trace import STEP_MARK, WINDOW_MARK, span, traced

MAX_CALLS = 1 << 16


def checked(ctx) -> list:
    """The pool's batches whose answers the reference recomputes: in a traced
    run all of them, whose set input bits K3's roofline counts."""
    n = int(ctx.traffic["pool_batches"])
    return draw(ctx, n, n if ctx.trace else min(int(ctx.traffic["check_batches"]), n))


def make_pool(ctx, dev) -> list:
    """The traffic's batches of (B, T, M) float32 frames, from the seed."""
    tr, cfg = ctx.traffic, ctx.cfg
    gen = signals.generator(ctx.seed, dev)
    array = signals.ArraySpec(cfg.model["array"])
    lo, hi = tr["snr_db"]
    pool = []
    for _ in range(int(tr["pool_batches"])):
        doa = signals.uniform(gen, int(tr["batch"]), -math.pi, math.pi, dev)
        snr = signals.uniform(gen, int(tr["batch"]), lo, hi, dev)
        pool.append(signals.array_audio(array, cfg.source(), doa, snr, cfg.frame_samples, cfg.fs, gen))
    return pool


def checked_inputs(ctx, dev):
    """(k·B, T, M) frames of the batches whose answers the reference
    recomputes, made as a run makes them."""
    import torch

    pool = make_pool(ctx, dev)
    return torch.cat([pool[b] for b in checked(ctx)])


def control(ctx, dev) -> dict:
    """The control's numbers (``check.control_offline``) on the frames that a
    run of this cell checks."""
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    x = checked_inputs(ctx, dev)
    want, _ = ref.offline_rates(model, x, dev)
    return check.control_offline(model, x, dev, want)


def window(demo, pool, seconds: float, host_doa, mark: bool):
    """Calls back to back for ``seconds``, in whole rounds of the pool;
    returns (calls, wall seconds, the last call's (doa, folded rate) of each
    pool batch, on the card)."""
    last = [None] * len(pool)
    calls = 0
    with span(WINDOW_MARK, mark):
        t_start = time.perf_counter()
        while True:
            b = calls % len(pool)
            with span(STEP_MARK, mark):
                doa, rate = demo.forward_batch(pool[b], "matched")
                host_doa[calls].copy_(doa, non_blocking=True)
            last[b] = (doa, rate)
            calls += 1
            if calls % len(pool) == 0 and (time.perf_counter() - t_start >= seconds or calls + len(pool) > MAX_CALLS):
                break  # whole rounds of the pool, so that every batch's answer is checked
        device.sync([pool[0].device])
        wall = time.perf_counter() - t_start
    return calls, wall, last


def shape(ctx, demo) -> dict:
    """The roofline's shape of one call."""
    cfg = ctx.cfg
    M = int(cfg.model["array"]["num_mic"])
    return dict(T=cfg.frame_samples, B=int(ctx.traffic["batch"]), M=M, F=cfg.bands, C=2 * M * cfg.bands,
                N=int(demo.xylo_config.w_in.shape[1]), G=int(cfg.model["grid_points"]), K=len(demo.kernel))


def run(ctx) -> Outcome:
    marks = device.Marks(ctx.t0)
    import torch

    from haghighatshoarmuir2024_tpu_torch.ops.cuda._build import launch_counts

    dev = ctx.devices[0]
    device.use(dev)
    demo = build_demo(ctx.cfg, dev)
    marks("the port's import and Demo")
    pool = make_pool(ctx, dev)
    marks("pool")
    for x in pool:  # every shape the window uses, and the kernel library's load (or build)
        demo.forward_batch(x, "matched")
    device.sync([dev])
    marks("first calls")
    B = int(ctx.traffic["batch"])
    host_doa = device.host_buffer((MAX_CALLS, B), torch.float64, dev)
    setup_s = marks("host buffer")

    view = None
    if ctx.trace:
        before = dict(launch_counts)
        (calls, wall, last), view = traced(
            lambda: window(demo, pool, min(ctx.seconds, float(ctx.traffic["trace_seconds"])), host_doa, True))
        view.launches = {k: v - before.get(k, 0) for k, v in launch_counts.items()}
        view.calls, view.shape = calls, shape(ctx, demo)
    else:
        calls, wall, last = window(demo, pool, ctx.seconds, host_doa, False)
    memory_peak = device.memory_peak([dev])

    doas = host_doa[:calls].numpy()
    n = len(pool)
    last_doa = [last[b][0].cpu().numpy() for b in range(n)]
    repeat_diff = sum(int((doas[i] != last_doa[i % n]).sum()) for i in range(calls))
    picked = checked(ctx)
    prog_doa = np.stack([last_doa[b] for b in picked])  # (k, B)
    prog_rate = np.stack([last[b][1].cpu().numpy() for b in picked])  # (k, B, G)
    del demo, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    x = torch.cat([pool[b] for b in picked])
    ref_rates, nnz = ref.offline_rates(model, x, dev)
    checks = check.offline(model, prog_rate.reshape(len(picked) * B, -1), prog_doa.reshape(-1), ref_rates)
    checks["repeat_diff"] = repeat_diff
    print(f"[check] the reference {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    if view is not None:
        view.nnz = nnz / len(picked)  # set input bits a call, the pool's mean
    e2e = {"audio_s_per_s": calls * B * float(ctx.cfg.model["frame_s"]) / wall, "setup_s": setup_s}
    return Outcome(e2e=e2e, attempted=calls * B, failed=int(np.isnan(doas).sum()), memory_peak_bytes=memory_peak,
                   checks=checks, view=view)
