"""Live float-SNN localization demo (counterpart of
``haghighatshoarmuir2024_tpu/demos/localization_demo_snn.py``; reference:
micloc/localization_demo_snn.py).

The Hilbert demo's loop through ``SNNBeamformer.apply_to_signal``: the
per-band RZCC spikes → LIF membrane → beamforming, the DoA at the argmax of
the summed mean squared membrane (micloc/localization_demo_snn.py:58-98,166-193).

    python -m haghighatshoarmuir2024_tpu_torch.demos.localization_demo_snn [--frames N] [--device cpu]
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, CenterCircularArray, resolve_device
from ..io import AudioSource, Visualizer
from ..models.snn_beamformer import SNNBeamformer
from ..ops.filterbank import ButterworthFilterbank
from ..utils.profiling import StageTimer
from .localization_demo import cli, run_frames, to_device, tone_source


class Demo:
    """Per-band float SNN beamformers (both time constants 1/(2π f_mid))
    designed at each band's centre on ``device`` (the card unless
    ``"cpu"``), the order-1 filterbank, and the live loop."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_bands,
        doa_list,
        recording_duration: float = 0.25,
        kernel_duration: float = 10e-3,
        bipolar_spikes: bool = True,
        fs: float = FS,
        source: Optional[AudioSource] = None,
        visualizer: Optional[Visualizer] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.geometry = geometry
        self.freq_bands = np.atleast_2d(np.asarray(freq_bands, dtype=np.float64))
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.recording_duration = recording_duration
        self.fs = fs
        self.source = source
        self.vz = visualizer or Visualizer(headless=True)
        self.timer = StageTimer()

        self.beamfs: List[SNNBeamformer] = []
        self.bf_mats = []
        time_temp = np.arange(0, recording_duration, 1 / fs)
        for band in self.freq_bands:
            f_mid = float(np.mean(band))
            tau = 1.0 / (2 * np.pi * f_mid)
            bf = SNNBeamformer(geometry, kernel_duration, band, [tau, tau], bipolar_spikes=bipolar_spikes, fs=fs,
                               device=self.device)
            self.bf_mats.append(bf.design_from_template((time_temp, np.sin(2 * np.pi * f_mid * time_temp)),
                                                        self.doa_list))
            self.beamfs.append(bf)
        self.filterbank = ButterworthFilterbank(self.freq_bands, order=1, fs=fs)

    def power(self, data) -> torch.Tensor:
        """One frame (T, M) → the summed mean squared membranes (G,) on the
        device."""
        bands = self.filterbank(to_device(data, self.device))  # (F, T, M)
        t = np.arange(bands.shape[1]) / self.fs
        power = torch.zeros(len(self.doa_list), device=self.device)
        for band, bf, bf_mat in zip(bands, self.beamfs, self.bf_mats):
            power = power + (bf.apply_to_signal(bf_mat, (t, band)) ** 2).mean(dim=0)
        return power

    def process_frame(self, data) -> float:
        """One frame → DoA estimate (radians)."""
        return float(self.doa_list[int(torch.argmax(self.power(data)))])

    def run(self, num_frames: Optional[int] = None) -> list:
        return run_frames(self.source, self.recording_duration, self.process_frame, self.vz, self.timer, num_frames)


def reference_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> Demo:
    """The reference-default configuration (7 mics, 1600-1900 Hz, a
    224-point grid, bipolar spikes) on a synthetic source."""
    num_mic = 7
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=num_mic)
    return Demo(geometry, [[1600.0, 1900.0]], np.linspace(-np.pi, np.pi, 32 * num_mic),
                source=tone_source(geometry, num_frames, snr_db, doa), device=device)


def run_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> list:
    return reference_demo(num_frames, snr_db, doa, device).run(num_frames=num_frames)


if __name__ == "__main__":
    cli(run_demo)
