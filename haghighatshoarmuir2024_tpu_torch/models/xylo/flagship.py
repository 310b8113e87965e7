"""The flagship configuration and frames of ``bench.py`` (``bench.py:94-131``):
a 7-microphone CenterCircularArray of radius 4.5 cm, one band 1600-1900 Hz,
48 kHz, 0.25 s frames, a 449-point grid; frames of a 1750 Hz tone from
``batch`` directions on the array, plus 0.1 white noise from a seed."""
from __future__ import annotations

import numpy as np
import torch

from ...geometry import CenterCircularArray
from ...ops.interp import signal_from_template

FS, FRAME, GRID = 48_000, 0.25, 64 * 7 + 1


def flagship_config(device, bipolar: bool = True) -> dict:
    """``Demo``'s keyword arguments for the flagship on ``device``."""
    return dict(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1600, 1900]],
                doa_list=np.linspace(-np.pi, np.pi, GRID), recording_duration=FRAME, kernel_duration=10e-3,
                bipolar_spikes=bipolar, fs=FS, device=device)


def flagship_frames(demo, batch: int, seed: int = 0):
    """(B, T, M) float32 frames on the demo's device, and their directions."""
    t = torch.arange(0, FRAME, 1 / FS, dtype=torch.float64, device=demo.device)
    sig = torch.sin(2 * np.pi * 1750 * t)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    frames = torch.stack([signal_from_template(demo.geometry, t, sig, d, fs=FS) for d in doas])
    noise = 0.1 * np.random.default_rng(seed).standard_normal(tuple(frames.shape)).astype(np.float32)
    return frames.to(torch.float32) + torch.as_tensor(noise, device=demo.device), doas
