"""The three-band configuration of ``experiments/multiband_bench.py:41-115``:
the flagship's 7-microphone CenterCircularArray and 449-point grid with the
reference live benchmark's three bands, 1600-2000, 2000-2300 and 2300-2600
Hz (C = 42 channels a polarity, N = 1347 hidden neurons, past the Xylo-A2
chip's 1000: ``enforce_hw_limits=False``), bipolar, 0.25 s frames, at 48 or
24 kHz; frames of the wideband template, the jittered sum of the band
centres, from ``batch`` directions, plus 0.1 white noise from a seed."""
from __future__ import annotations

import numpy as np
import torch

from ...config import FS
from ...geometry import CenterCircularArray
from ...ops.interp import signal_from_template
from .flagship import FRAME, GRID

BANDS = [[1600.0, 2000.0], [2000.0, 2300.0], [2300.0, 2600.0]]


def multiband_config(device, fs: int = 48_000) -> dict:
    """``Demo``'s keyword arguments for the three-band model at ``fs``."""
    return dict(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=BANDS,
                doa_list=np.linspace(-np.pi, np.pi, GRID), recording_duration=FRAME, kernel_duration=10e-3,
                bipolar_spikes=True, fs=fs, enforce_hw_limits=False, device=device)


def jittered_sinusoid_template(freq: float, duration: float, fs: float = FS, eps: float = 0.01, seed: int = 0):
    """A sinusoid with a small random frequency jitter, which steadies the
    zero crossings of SNN designs (the port's copy of JAX
    ``experiments/common.py:39-46``; paper_plots/array_resolution_linear_snn.py:173-181)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0, duration, 1 / fs)
    freq_inst = freq * (1 + eps * rng.standard_normal(len(t)))
    return t, np.sin(2 * np.pi * np.cumsum(freq_inst) / fs)


def wideband_template(fs: int):
    """The jittered sum of the three band centres, peak 1
    (``multiband_bench.py:77-85``)."""
    t = np.arange(0, FRAME, 1 / fs)
    sig = np.zeros_like(t)
    for band in BANDS:
        sig = sig + jittered_sinusoid_template(float(np.mean(band)), FRAME, fs=fs, seed=1)[1]
    return t, sig / np.abs(sig).max()


def multiband_frames(demo, batch: int, seed: int = 0):
    """(B, T, M) float32 frames of :func:`wideband_template` on the demo's
    device, their directions, and the template."""
    t, sig = wideband_template(demo.fs)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    tt = torch.as_tensor(t, device=demo.device)
    ss = torch.as_tensor(sig, device=demo.device)
    frames = torch.stack([signal_from_template(demo.geometry, tt, ss, d, fs=demo.fs) for d in doas])
    noise = 0.1 * np.random.default_rng(seed).standard_normal(tuple(frames.shape)).astype(np.float32)
    return frames.to(torch.float32) + torch.as_tensor(noise, device=demo.device), doas, (t, sig)
