"""Live Hilbert (non-SNN) localization demo (counterpart of
``haghighatshoarmuir2024_tpu/demos/localization_demo.py``; reference:
micloc/localization_demo.py).

The reference's loop: record 0.25 s → per-band ``Beamformer.apply_to_signal``
→ accumulate band powers → argmax DoA → push to the visualizer
(micloc/localization_demo.py:117-185).  The audio comes from an
:class:`~haghighatshoarmuir2024_tpu_torch.io.AudioSource`; each frame goes
to the demo's device once as float32 and stays there up to the DoA, the one
number the loop pushes.

    python -m haghighatshoarmuir2024_tpu_torch.demos.localization_demo [--frames N] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, CenterCircularArray, resolve_device
from ..io import AudioSource, SyntheticAudioSource, Visualizer
from ..models.beamformer import Beamformer
from ..ops.filterbank import ButterworthFilterbank
from ..utils.profiling import StageTimer


def run_frames(source: Optional[AudioSource], duration: float, process_frame: Callable, vz: Visualizer,
               timer: StageTimer, num_frames: Optional[int] = None) -> list:
    """The demos' loop: each frame of ``source`` → ``process_frame`` (a DoA
    in radians, NaN for none) → degrees pushed to ``vz``; returns the
    degrees.  ``timer`` takes each step's seconds under ``source``,
    ``compute`` and ``visualize``."""
    if source is None:
        raise ValueError("no audio source configured")
    frames = source.frames(duration)
    estimates = []
    while num_frames is None or len(estimates) < num_frames:
        with timer.stage("source"):
            frame = next(frames, None)
        if frame is None:
            break
        with timer.stage("compute"):
            deg = float(np.rad2deg(process_frame(frame)))
        with timer.stage("visualize"):
            vz.push(deg)
        estimates.append(deg)
    return estimates


def to_device(data, device: torch.device) -> torch.Tensor:
    """One host frame (T, M) → float32 on ``device``."""
    return torch.as_tensor(np.asarray(data, dtype=np.float32), device=device)


class Demo:
    """Per-band Hilbert beamformers designed at each band's centre on
    ``device`` (the card unless ``"cpu"``), the order-1 Butterworth
    filterbank, and the live loop.  ``timer`` holds the loop's stage
    times."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_bands,
        doa_list,
        recording_duration: float = 0.25,
        kernel_duration: float = 10e-3,
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

        # per-band design at the band centre (micloc/localization_demo.py:56-77)
        self.beamfs: List[Beamformer] = []
        self.bf_mats = []
        time_temp = np.arange(0, recording_duration, 1 / fs)
        for band in self.freq_bands:
            f_mid = float(np.mean(band))
            bf = Beamformer(geometry, kernel_duration, band, fs=fs, device=self.device)
            bf_mat, _ = bf.design_from_template((time_temp, np.sin(2 * np.pi * f_mid * time_temp)), self.doa_list)
            self.beamfs.append(bf)
            self.bf_mats.append(bf_mat)
        self.filterbank = ButterworthFilterbank(self.freq_bands, order=1, fs=fs)

    def power(self, data) -> torch.Tensor:
        """One frame (T, M) → the summed band powers (G,) on the device."""
        bands = self.filterbank(to_device(data, self.device))  # (F, T, M)
        power = torch.zeros(len(self.doa_list), device=self.device)
        for band, bf, bf_mat in zip(bands, self.beamfs, self.bf_mats):
            power = power + (bf.apply_to_signal(bf_mat, band).abs() ** 2).mean(dim=0)
        return power

    def process_frame(self, data) -> float:
        """One frame → DoA estimate (radians)."""
        return float(self.doa_list[int(torch.argmax(self.power(data)))])

    def run(self, num_frames: Optional[int] = None) -> list:
        """Process frames from the source, pushing each DoA (degrees) to the
        visualizer; returns the estimates."""
        return run_frames(self.source, self.recording_duration, self.process_frame, self.vz, self.timer, num_frames)


def tone_source(geometry, num_frames: int, snr_db: float, doa: float, delay_sign: int = 1) -> SyntheticAudioSource:
    """The reference demos' synthetic input: a 1750 Hz tone from ``doa``,
    ``num_frames + 1`` frames of 0.25 s, white noise at ``snr_db`` from
    seed 0."""
    t = np.arange(0, 0.25 * (num_frames + 1), 1 / FS)
    return SyntheticAudioSource(geometry, t, np.sin(2 * np.pi * 1750.0 * t), doa, snr_db=snr_db, fs=FS,
                                delay_sign=delay_sign)


def reference_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> Demo:
    """The reference-default configuration (micloc/localization_demo.py:188-217:
    7 mics, 1600-1900 Hz, a 224-point grid) on a synthetic source."""
    num_mic = 7
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=num_mic)
    return Demo(geometry, [[1600.0, 1900.0]], np.linspace(-np.pi, np.pi, 32 * num_mic),
                source=tone_source(geometry, num_frames, snr_db, doa), device=device)


def run_demo(num_frames: int = 8, snr_db: float = 10.0, doa: float = 0.7, device=None) -> list:
    return reference_demo(num_frames, snr_db, doa, device).run(num_frames=num_frames)


def cli(run_demo: Callable, argv=None) -> list:
    """A demo module's command line: ``run_demo`` at its defaults, or
    ``--frames N``, on ``--device`` (the card unless ``cpu``); prints the
    DoAs in degrees."""
    ap = argparse.ArgumentParser(description="live localization demo on a synthetic source")
    ap.add_argument("--frames", type=int, default=None, help="frames to process (default: the demo's)")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    kw = {} if args.frames is None else {"num_frames": args.frames}
    est = run_demo(device=args.device, **kw)
    print(est)
    return est


if __name__ == "__main__":
    cli(run_demo)
