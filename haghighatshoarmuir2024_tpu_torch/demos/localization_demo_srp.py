"""Live SRP-PHAT localization demo (counterpart of
``haghighatshoarmuir2024_tpu/demos/localization_demo_srp.py``).  The
reference ships live demos for the Hilbert, SNN and MUSIC families only;
this one runs the classical TDoA baseline through the same loop and
estimators as the MUSIC demo.

    python -m haghighatshoarmuir2024_tpu_torch.demos.localization_demo_srp [--frames N] [--device cpu]
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, CenterCircularArray
from ..io import AudioSource, Visualizer
from ..models.srp_phat import SRPPHAT
from ..utils.profiling import StageTimer
from .localization_demo import cli, run_frames, to_device, tone_source
from .localization_demo_music import spectrum_doa


class Demo:
    """``SRPPHAT.apply_to_signal`` of each frame on ``device`` (the card
    unless ``"cpu"``) and the live loop."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_range,
        doa_list,
        recording_duration: float = 0.25,
        fs: float = FS,
        source: Optional[AudioSource] = None,
        visualizer: Optional[Visualizer] = None,
        device=None,
    ):
        self.srp = SRPPHAT(geometry, freq_range, doa_list, fs=fs, frame_duration=recording_duration, device=device)
        self.device = self.srp.device
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.recording_duration = recording_duration
        self.fs = fs
        self.source = source
        self.vz = visualizer or Visualizer(headless=True)
        self.timer = StageTimer()

    def estimate_doa(self, ang_pow_spec, method: str = "peak") -> float:
        """The MUSIC demo's estimators (see
        :func:`~haghighatshoarmuir2024_tpu_torch.demos.localization_demo_music.spectrum_doa`)."""
        return spectrum_doa(torch.as_tensor(ang_pow_spec, device=self.device), self.doa_list, method)

    def process_frame(self, data, method: str = "peak") -> float:
        return self.estimate_doa(self.srp.apply_to_signal(to_device(data, self.device)), method=method)

    def run(self, num_frames: Optional[int] = None, method: str = "peak") -> list:
        return run_frames(self.source, self.recording_duration, lambda f: self.process_frame(f, method), self.vz,
                          self.timer, num_frames)


def reference_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> Demo:
    """7 mics, 1400-2100 Hz, a 224-point grid, on a synthetic source of the
    ``t - delay`` convention that SRP's steering expects (``delay_sign=-1``)."""
    num_mic = 7
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=num_mic)
    return Demo(geometry, [1400.0, 2100.0], np.linspace(-np.pi, np.pi, 32 * num_mic),
                source=tone_source(geometry, num_frames, snr_db, doa, delay_sign=-1), device=device)


def run_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> list:
    return reference_demo(num_frames, snr_db, doa, device).run(num_frames=num_frames)


if __name__ == "__main__":
    cli(run_demo)
