"""Per-stage timing and device tracing (counterpart of
``haghighatshoarmuir2024_tpu/utils/profiling.py``).

The reference times its hot calls with ad-hoc ``time.time()`` prints
(micloc/xylo_snn_localization.py:516-523).  :class:`StageTimer` gives the
same per-stage wall numbers as data, :func:`benchmark_fn` the mean of a
call, both waiting for the card before the clock is read; :func:`device_trace`
records a ``torch.profiler`` trace (CPU and, where there is a card, CUDA
activity) as a Chrome/Perfetto JSON file.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves


def wait_for(out) -> None:
    """Wait for the card on each device that holds a CUDA tensor of the
    pytree ``out`` (JAX: ``jax.block_until_ready``)."""
    for dev in {x.device for x in tree_leaves(out) if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall time per named stage; :meth:`timed` waits for the
    device results, so the numbers are the device's work, not its enqueue.
    ``samples[name]`` keeps each call's seconds (for a median)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.samples.setdefault(name, []).append(dt)

    def timed(self, name: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            with self.stage(name):
                out = fn(*args, **kwargs)
                wait_for(out)
            return out

        return wrapper

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "calls": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / self.counts[k],
            }
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler.profile`` over the block that writes a
    Chrome/Perfetto trace JSON (``*.pt.trace.json``) into ``log_dir`` when
    the block ends, and yields the profiler; a no-op yielding None when
    ``log_dir`` is None.  Activity tracing only (CUPTI's kernel records),
    no hardware counters."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


def benchmark_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> Dict[str, float]:
    """The mean wall time of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, the device waited for once at the end."""
    for _ in range(warmup):
        wait_for(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    wait_for(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "mean_ms": dt * 1e3, "iters": iters}
