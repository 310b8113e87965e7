"""Helpers of the per-layer metric readers (``metrics/<name>.py``): device
time of the kernels a pattern names, a call, and the traced window's shares.
Each reader holds its own pattern: the kernel names of its layer."""
from __future__ import annotations

from . import roofline


def per_call_ms(view, pattern: str):
    """Device milliseconds a call of the kernels whose names match
    ``pattern``, summed over the cards, or None where none ran."""
    if not view.calls or not view.kernel_count(pattern):
        return None
    return view.kernel_us(pattern) / 1e3 / view.calls


def roofline_pct(view, pattern: str, bound_s: float):
    """The share (%) of a kernel's bound, ``bound_s`` a call, in its measured
    device time a call; None where it did not run."""
    ms = per_call_ms(view, pattern)
    return None if ms is None else 100.0 * bound_s * 1e3 / ms


def idle_pct(view):
    """The traced window's share (%) in which no kernel or copy ran, the mean
    over the cards."""
    return 100.0 * (1.0 - view.mean_busy_s() / view.window_s)


def step_mfu_pct(view):
    """The whole step's share (%) of the chip's peak: the least time its
    kernels' work takes at the peaks (``roofline.step_bound_s``), summed
    over the cards, over the cards' wall time a call in the window."""
    if not view.calls or view.nnz is None:
        return None
    least = sum(roofline.step_bound_s(view.shape, view.nnz).values()) * view.devices
    return 100.0 * least / (view.window_s * view.devices / view.calls)
