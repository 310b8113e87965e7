"""Audio sources (counterpart of ``haghighatshoarmuir2024_tpu/io/audio.py``;
reference recorder: micloc/record.py:21-83).

* :class:`SyntheticAudioSource` — the array signal of a template and a DoA
  (trajectory), with optional white noise from a seed;
* :class:`FileAudioSource` — frames of an audio file (wav by scipy, flac by
  the bundled decoder, other formats by ``soundfile`` where installed);
* :class:`AudioRecorder` — live capture through ``sox``, raising
  :class:`MultiMicDevKitNotFound` without it or the dev board.

Frames are host (T, channels) float32 arrays.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class MultiMicDevKitNotFound(Exception):
    """The multi-mic dev kit or its sox capture is unavailable
    (micloc/record.py:21-22)."""


class AudioSource:
    """Protocol: ``frames(duration)`` yields (T, num_channels) float arrays."""

    fs: float = 48_000.0
    num_channels: int = 7
    _sig: np.ndarray

    def frames(self, duration: float) -> Iterator[np.ndarray]:
        n = int(self.fs * duration)
        for start in range(0, self._sig.shape[0] - n + 1, n):
            yield self._sig[start:start + n]


class SyntheticAudioSource(AudioSource):
    """Array signal synthesized from (template, DoA trajectory) + noise.
    ``delay_sign=-1`` is the MUSIC/SRP synthesis convention (see
    ``ops.interp.signal_from_template``); synthesized in float64 on the
    host."""

    def __init__(self, geometry, time_temp: np.ndarray, sig_temp: np.ndarray, doa, snr_db: Optional[float] = None,
                 fs: float = 48_000.0, seed: int = 0, delay_sign: int = 1):
        from ..ops.interp import signal_from_template

        self.fs = fs
        self.num_channels = len(geometry)
        f64 = dict(dtype=torch.float64)
        sig_in = signal_from_template(geometry, torch.as_tensor(np.asarray(time_temp), **f64),
                                      torch.as_tensor(np.asarray(sig_temp), **f64), doa, fs=fs,
                                      delay_sign=delay_sign).numpy()
        if snr_db is not None:
            sigma = np.sqrt(np.mean(sig_in**2) / 10 ** (snr_db / 10))
            sig_in = sig_in + sigma * np.random.default_rng(seed).standard_normal(sig_in.shape)
        self._sig = sig_in.astype(np.float32)


class FileAudioSource(AudioSource):
    """Frames of a multi-channel audio file, linearly resampled to ``fs``
    when the file's rate differs."""

    def __init__(self, path: str, fs: Optional[float] = None):
        data, file_fs = _read_audio(path)
        if data.ndim == 1:
            data = data[:, None]
        if fs is not None and fs != file_fs:
            t_old = np.arange(data.shape[0]) / file_fs
            t_new = np.arange(0, t_old[-1], 1.0 / fs)
            data = np.stack([np.interp(t_new, t_old, data[:, c]) for c in range(data.shape[1])], axis=1)
            file_fs = fs
        self.fs = file_fs
        self.num_channels = data.shape[1]
        self._sig = data.astype(np.float32)


def _read_audio(path: str) -> Tuple[np.ndarray, float]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        from scipy.io import wavfile

        fs, data = wavfile.read(path)
        if np.issubdtype(data.dtype, np.integer):
            data = data.astype(np.float64) / np.iinfo(data.dtype).max
        return np.asarray(data, dtype=np.float64), float(fs)
    if ext == ".flac":
        from .flac import read_flac

        return read_flac(path)
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(f"reading {ext} files requires the optional `soundfile` package") from e
    data, fs = sf.read(path, always_2d=False)
    return np.asarray(data, dtype=np.float64), float(fs)


class AudioRecorder:
    """Live capture via sox (micloc/record.py:25-83)."""

    def __init__(self, num_channels: int = 8, buffer_size: int = 2048):
        self.num_channels = num_channels
        self.buffer_size = buffer_size

    def record_file(self, duration: float, bits: int = 16, fs: int = 48_000):
        """``duration`` seconds from the dev board, (T, num_channels) int;
        raises :class:`MultiMicDevKitNotFound` when sox or the device is
        missing (micloc/record.py:54-68)."""
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            fname = f.name
        cmd = ["sox", "-b", str(bits), "-e", "signed-integer", "-r", str(fs), "-c", str(self.num_channels),
               "-d", "--clobber", "--buffer", str(self.buffer_size), fname, "trim", "0", str(duration)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            from scipy.io import wavfile

            return wavfile.read(fname)[1]
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise MultiMicDevKitNotFound(
                "could not record from the multi-mic dev kit (sox unavailable or no capture device); "
                "use SyntheticAudioSource or FileAudioSource") from e
        finally:
            os.unlink(fname)
