"""Live MUSIC localization demo (counterpart of
``haghighatshoarmuir2024_tpu/demos/localization_demo_music.py``; reference:
micloc/localization_demo_MUSIC.py, defaults :202-219: band 1200-2000 Hz,
100 active bins of a 2048-bin FFT).

    python -m haghighatshoarmuir2024_tpu_torch.demos.localization_demo_music [--frames N] [--device cpu]
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, CenterCircularArray
from ..io import AudioSource, Visualizer
from ..models.music import MUSIC
from ..utils.peak_location import find_peak_location
from ..utils.profiling import StageTimer
from .localization_demo import cli, run_frames, to_device, tone_source


def spectrum_doa(aps: torch.Tensor, doa_list: np.ndarray, method: str = "peak") -> float:
    """DoA (radians) from an angular power spectrum (G,)
    (micloc/localization_demo_MUSIC.py:61-105): ``"peak"``, the argmax after
    a moving average over about a 32nd of the grid (periodic), or
    ``"periodic_ml"``, the angle of the spectrum-weighted mean of
    ``exp(j·doa)`` in float64."""
    if method == "peak":
        win = max(1, 2 * ((len(doa_list) // 32) // 2) + 1)
        idx = find_peak_location(aps, win) if win > 1 else torch.argmax(aps)
        return float(doa_list[int(idx)])
    if method == "periodic_ml":
        steer = torch.exp(1j * torch.as_tensor(doa_list, device=aps.device))
        return float(torch.angle((aps.to(torch.float64) * steer).mean()))
    raise ValueError(f"unknown method {method}")


class Demo:
    """``MUSIC.beamforming`` of each frame on ``device`` (the card unless
    ``"cpu"``) and the live loop."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_range,
        doa_list,
        recording_duration: float = 0.25,
        num_active_freq: int = 100,
        num_fft_bin: int = 2048,
        fs: float = FS,
        source: Optional[AudioSource] = None,
        visualizer: Optional[Visualizer] = None,
        device=None,
    ):
        self.music = MUSIC(geometry, freq_range, doa_list, frame_duration=recording_duration, fs=fs, device=device)
        self.device = self.music.device
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.recording_duration = recording_duration
        self.num_active_freq = num_active_freq
        self.num_fft_bin = num_fft_bin
        self.fs = fs
        self.source = source
        self.vz = visualizer or Visualizer(headless=True)
        self.timer = StageTimer()

    def estimate_doa(self, ang_pow_spec, method: str = "peak") -> float:
        """DoA from the angular power spectrum (see :func:`spectrum_doa`)."""
        return spectrum_doa(torch.as_tensor(ang_pow_spec, device=self.device), self.doa_list, method)

    def process_frame(self, data, method: str = "peak") -> float:
        aps = self.music.beamforming(to_device(data, self.device), self.num_active_freq, self.num_fft_bin)
        return self.estimate_doa(aps, method=method)

    def run(self, num_frames: Optional[int] = None, method: str = "peak") -> list:
        return run_frames(self.source, self.recording_duration, lambda f: self.process_frame(f, method), self.vz,
                          self.timer, num_frames)


def reference_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> Demo:
    """The reference-default configuration on a synthetic source.  MUSIC's
    steering matches the ``t - delay`` synthesis (``delay_sign=-1``);
    audio of the other convention mirrors the estimates by 180 deg."""
    num_mic = 7
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=num_mic)
    return Demo(geometry, [1200.0, 2000.0], np.linspace(-np.pi, np.pi, 32 * num_mic),
                source=tone_source(geometry, num_frames, snr_db, doa, delay_sign=-1), device=device)


def run_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> list:
    return reference_demo(num_frames, snr_db, doa, device).run(num_frames=num_frames)


if __name__ == "__main__":
    cli(run_demo)
