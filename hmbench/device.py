"""The few calls that differ between the card and the CPU, on which the
harness's own tests drive a cell at a small size."""
from __future__ import annotations

import sys
import time

import torch


def use(device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def host_buffer(shape, dtype, device) -> torch.Tensor:
    """A host buffer that copies from ``device`` land in without a wait:
    pinned where ``device`` is a card."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def memory_peak(devices) -> int:
    """The peak of allocated memory on the fullest card (0 on the CPU)."""
    return max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"), default=0)


class Marks:
    """Set-up's phases on standard error (``[setup] <phase> <s>`` from the
    previous mark, the first from when the marks were made); a call returns
    the seconds since ``t0``."""

    def __init__(self, t0: float):
        self.t0, self.last = t0, time.perf_counter()

    def __call__(self, phase: str) -> float:
        now = time.perf_counter()
        print(f"[setup] {phase} {now - self.last:.3f} s", file=sys.stderr, flush=True)
        self.last = now
        return now - self.t0
