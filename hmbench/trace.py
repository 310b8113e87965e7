"""The traced window: ``torch.profiler`` with CUPTI's activity records (as
the port's ``utils/profiling.device_trace``), read back into a :class:`View`
that the per-layer metric readers take.

A trace that holds no kernel record is taken again, up to
``TRACE_ATTEMPTS`` times (the port's ``experiments/hand_kernels.traced_ms``
does the same: on the H100 machine a trace once came back without the GPU's
records).  The trace file goes to the run's ``TMPDIR`` and is deleted once
read.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

TRACE_ATTEMPTS = 3
WINDOW_MARK = "hmbench.window"
STEP_MARK = "hmbench.step"


class View:
    """What one traced window holds, on the trace's clock (microseconds).

    ``kernels`` and ``copies`` are ``(device, name, start, duration)``;
    ``host`` ``(name, start, duration)`` of the host's operations and runtime
    calls; ``steps`` the harness's step spans ``(start, end)``.  The driver
    adds ``calls`` (timed calls in the window), ``step_ms`` (their host
    times), ``launches`` (the port's kernel launch counter over the window),
    ``shape`` and ``nnz`` (the roofline's inputs) and ``devices``."""

    def __init__(self, events: list):
        self.kernels, self.copies, self.host, self.steps = [], [], [], []
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat == "kernel":
                self.kernels.append((int(args.get("device", 0)), e.get("name", ""), ts, dur))
            elif cat in ("gpu_memcpy", "gpu_memset"):
                self.copies.append((int(args.get("device", 0)), e.get("name", ""), ts, dur))
            elif cat == "user_annotation" and e.get("name") == WINDOW_MARK:
                self.window = (ts, ts + dur)
            elif cat == "user_annotation" and e.get("name") == STEP_MARK:
                self.steps.append((ts, ts + dur))
            elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
                self.host.append((e.get("name", ""), ts, dur))
        self.steps.sort()
        self.calls = 0
        self.step_ms: list = []
        self.launches: dict = {}
        self.shape: dict = {}
        self.nnz = None
        self.devices = 1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernel_us(self, pattern: str) -> float:
        """Device microseconds of the kernels whose name matches ``pattern``
        (a regular expression), summed over the cards."""
        rx = re.compile(pattern)
        return sum(d for _, n, _, d in self.kernels if rx.search(n))

    def kernel_count(self, pattern: str = "") -> int:
        rx = re.compile(pattern)
        return sum(1 for _, n, _, _ in self.kernels if rx.search(n))

    def busy_intervals(self, device: int) -> list:
        """Merged intervals in which a kernel or a copy ran on ``device``,
        cut to the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(s + d, hi)) for dev, _, s, d in self.kernels + self.copies
                    if dev == device and s + d > lo and s < hi)
        merged: list = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self, device: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(device)) / 1e6

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in range(self.devices)) / self.devices

    def idle_gaps(self, device: int) -> list:
        """``(start, end)`` of the window's stretches with nothing running on
        ``device``."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals(device):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def host_at(self, times) -> list:
        """The innermost host operation running at each of ``times`` (sorted),
        or ``"host idle"``: one sweep over the host's operations by start."""
        host = sorted(self.host, key=lambda h: h[1])
        out, active, i = [], [], 0
        for t in times:
            while i < len(host) and host[i][1] <= t:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] + h[2] >= t]
            out.append(min(active, key=lambda h: h[2])[0] if active else "host idle")
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:64]


def breakdown(view: View) -> dict:
    """The contract's ``breakdown``: the ten device operations that took most
    time (seconds, summed over the window and the cards, by kernel name) and
    the ten host operations under which the cards sat idle longest (seconds
    of idle time, summed)."""
    ops: dict = defaultdict(float)
    for _, n, _, d in view.kernels + view.copies:
        ops[short_name(n)] += d / 1e6
    gaps: dict = defaultdict(float)
    for dev in range(view.devices):
        spans = view.idle_gaps(dev)
        for (s, e), name in zip(spans, view.host_at([(s + e) / 2 for s, e in spans])):
            gaps[name] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def span(name: str, on: bool):
    """A profiler range named ``name`` in a traced run (``on``), else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def _profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def traced(fn) -> tuple:
    """Run ``fn()`` (which marks its window with :data:`WINDOW_MARK` and each
    step with :data:`STEP_MARK`) under the profiler; returns ``(fn's result,
    View)``.  Retried while the trace holds no kernel record."""
    import torch

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with _profile() as prof:
            result = fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        view = View(events)
        if view.kernels and view.window is not None:
            return result, view
        print(f"[trace] trace {attempt} of {TRACE_ATTEMPTS} held no kernel record ({len(events)} events)",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler recorded no CUDA kernel in {TRACE_ATTEMPTS} traces")
