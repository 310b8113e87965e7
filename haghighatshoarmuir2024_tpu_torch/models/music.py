"""Narrowband "MUSIC" beamformer (counterpart of
``haghighatshoarmuir2024_tpu/models/music.py``; reference:
micloc/music_beamformer.py:22-335).

Despite the reference's class name its algorithm is Bartlett beamforming on
the dominant FFT bins (micloc/music_beamformer.py:91-186).  Per frame:
order-1 bandpass (``iir_filter(method="scan")``, as JAX runs it) → framed
FFT → the in-band bins → the ``num_active_freq`` bins of most mean power →
``Σ_k mean_frames |A(f_k)ᴴ X(f_k)|²``.  ``num_sources ≥ 1`` is the JAX
package's true-MUSIC option: per dominant bin, the noise subspace of the
sub-frame covariance and the pseudospectrum ``Σ_k 1 / ‖E_nᴴ a‖²``.

Frames are a batch axis: :meth:`MUSIC.beamforming` takes (T, M) or (B, T, M),
and :meth:`MUSIC.apply_to_signal` runs all its full frames as one batch.
The steering is computed in float32, as the JAX package computes it on the
TPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, resolve_device
from ..ops.filterbank import ButterworthFilterbank
from ..ops.fir import full_fp32
from ..ops.iir import iir_filter
from ..ops.interp import received_signal

_MINUS_TWO_PI = float(np.float32(-2 * np.pi))  # the float32 constant of JAX's complex64 product


class MUSIC:
    """Narrowband beamformer (micloc/music_beamformer.py:22-335) computing on
    ``device``: the card by default, the CPU with ``device="cpu"``."""

    def __init__(self, geometry: ArrayGeometry, freq_range, doa_list, frame_duration: float = 0.25,
                 fs: float = FS, device=None):
        self.device = resolve_device(device)
        freq_range = np.asarray(freq_range, dtype=np.float64)
        if len(freq_range) != 2 or freq_range[0] > freq_range[1]:
            raise ValueError("frequency range should be a list containing the minimum and maximum frequency!")
        self.freq_range = freq_range
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.frame_duration = frame_duration
        self.fs = fs
        self.filterbank = ButterworthFilterbank(freq_bands=[freq_range], order=1, fs=fs)
        self.geometry = geometry
        # non-normalized steering delays, (M, G) (micloc/music_beamformer.py:76-81)
        self.delays = self.geometry.delays_np(self.doa_list, normalized=False).T
        self._delays_t = torch.as_tensor(self.delays, dtype=torch.float32, device=self.device)

    @classmethod
    def from_config(cls, config, geometry: ArrayGeometry, doa_list, device=None):
        """From a :class:`~haghighatshoarmuir2024_tpu_torch.config.MUSICConfig`."""
        return cls(geometry=geometry, freq_range=config.freq_range, doa_list=doa_list,
                   frame_duration=config.frame_duration, fs=config.fs, device=device)

    def array_response(self, freq_list) -> torch.Tensor:
        """Steering tensor ``exp(-j 2π f d)``, num_freq x num_mic x num_DoA,
        complex64 (micloc/music_beamformer.py:64-89)."""
        freqs = torch.as_tensor(freq_list, dtype=torch.float32, device=self.device)
        phase = (_MINUS_TWO_PI * freqs)[..., None, None] * self._delays_t
        return torch.polar(torch.ones_like(phase), phase)

    def _bins(self, num_fft_bin: int):
        """The in-band FFT bins.  The reference's frequency grid
        ``np.linspace(0, fs, nfft)`` includes the endpoint, so the bins are
        fs/(nfft-1) apart (micloc/music_beamformer.py:129); kept."""
        freq_vec = np.linspace(0, self.fs, num_fft_bin)
        fmin, fmax = self.freq_range
        mask = (fmin <= freq_vec) & (freq_vec <= fmax)
        return np.nonzero(mask)[0], freq_vec[mask]

    def _in_band(self, x: torch.Tensor, num_fft_bin: int) -> torch.Tensor:
        """(B, T, M) float32 frames → their in-band FFT bins (B, M, F, S):
        the order-1 bandpass, zero-padded or truncated to F whole FFT
        frames (micloc/music_beamformer.py:119-150)."""
        B, T, M = x.shape
        num_fft_frames = max(1, T // num_fft_bin)
        b, a = self.filterbank.ba_list[0]
        filt = iir_filter(b, a, x, axis=1, method="scan")
        n = num_fft_frames * num_fft_bin
        adj = torch.nn.functional.pad(filt[:, :n], (0, 0, 0, max(0, n - T)))
        spec = torch.fft.fft(adj.transpose(1, 2).reshape(B, M, num_fft_frames, num_fft_bin), dim=-1)
        return spec[..., torch.as_tensor(self._bins(num_fft_bin)[0], device=x.device)]

    @staticmethod
    def _top(sel: torch.Tensor, num_active_freq: int) -> torch.Tensor:
        """The (B, K) positions among the in-band bins of the K of most mean
        power, ``argsort(power)[-K:]`` as JAX takes them (a stable sort)."""
        power = (sel.abs() ** 2).mean(dim=(1, 2))  # (B, S)
        return torch.argsort(power, dim=-1, stable=True)[:, -num_active_freq:]

    def _dominant(self, x: torch.Tensor, num_active_freq: int, num_fft_bin: int) -> torch.Tensor:
        """The dominant bins of (B, T, M) frames: (B, K) positions among the
        in-band bins."""
        return self._top(self._in_band(x, num_fft_bin), num_active_freq)

    def _core(self, x: torch.Tensor, num_active_freq: int, num_fft_bin: int, num_sources: int) -> torch.Tensor:
        """(B, T, M) float32 frames → (B, G) spectra (JAX
        ``_beamforming_core``, ``music.py:26-112``)."""
        sel = self._in_band(x, num_fft_bin)
        B, M, num_fft_frames, _ = sel.shape
        top = self._top(sel, num_active_freq)
        freqs = torch.as_tensor(self._bins(num_fft_bin)[1], dtype=torch.float32, device=x.device)[top]
        X = torch.gather(sel, 3, top[:, None, None, :].expand(B, M, num_fft_frames, -1))  # (B, M, F, K)
        arr = self.array_response(freqs)  # (B, K, M, G)
        full_fp32()
        if num_sources > 0:
            Xk = X.permute(0, 3, 1, 2)  # (B, K, M, F)
            R = torch.matmul(Xk, Xk.mH) / num_fft_frames
            noise = torch.linalg.eigh(R)[1][..., : M - num_sources]  # (B, K, M, M-S)
            c = torch.matmul(noise.mH, arr)  # (B, K, M-S, G)
            denom = (c.abs() ** 2).sum(dim=-2)
            return (1.0 / torch.clamp(denom, min=1e-12)).sum(dim=1)
        Y = torch.matmul(arr.mH, X.permute(0, 3, 1, 2))  # (B, K, G, F)
        return (Y.abs() ** 2).mean(dim=-1).sum(dim=1)

    def beamforming(self, sig_in, num_active_freq: int, num_fft_bin: int, num_sources: int = 0) -> torch.Tensor:
        """Angular power spectrum (G,) of one frame (T, M), or (B, G) of a
        batch (B, T, M) (micloc/music_beamformer.py:91-186).
        ``num_sources=0`` is the reference's Bartlett path; ``num_sources≥1``
        the noise-subspace pseudospectrum."""
        x = torch.as_tensor(sig_in, device=self.device).to(torch.float32)
        fmin, fmax = self.freq_range
        if num_active_freq > int((fmax - fmin) / (self.fs / num_fft_bin)):
            raise ValueError("number of frequencies is quite large: it may happen that most of "
                             "these frequencies contain noise!")
        if x.dim() not in (2, 3) or x.shape[-1] != len(self.geometry):
            raise ValueError("input signal should be of dim `T x num_mic`!")
        if num_sources < 0 or num_sources >= len(self.geometry):
            raise ValueError("num_sources must be in [0, num_mic) — 0 selects the reference-parity Bartlett path")
        out = self._core(x if x.dim() == 3 else x[None], num_active_freq, num_fft_bin, num_sources)
        return out if x.dim() == 3 else out[0]

    def apply_to_signal(self, sig_in, num_active_freq: int, duration_overlap: float, num_fft_bin: int,
                        num_sources: int = 0) -> torch.Tensor:
        """Sliding-frame spectra (num_frames, G) of a (T, M) signal
        (micloc/music_beamformer.py:188-261): frames of ``frame_duration``
        overlapping by ``duration_overlap``, then a shorter tail frame when
        more than half a frame is left."""
        x = torch.as_tensor(sig_in, device=self.device).to(torch.float32)
        T, num_chan = x.shape
        if num_chan != len(self.geometry):
            raise ValueError("number of channels in the input signal should be the same as the "
                             "number of microphones!")
        frame = int(self.fs * self.frame_duration)
        overlap = int(self.fs * duration_overlap)
        if overlap >= frame:
            raise ValueError("duration of overlap window is larger than the duration of a single frame!")
        fresh = frame - overlap
        num_full = max(0, (T - frame) // fresh + 1)
        out = []
        if num_full > 0:
            frames = torch.stack([x[s:s + frame] for s in range(0, num_full * fresh, fresh)])
            out.append(self.beamforming(frames, num_active_freq, num_fft_bin, num_sources))
        start = num_full * fresh
        if (T - start) > 0.5 * frame:
            out.append(self.beamforming(x[start:T], num_active_freq, num_fft_bin, num_sources)[None])
        if not out:
            return torch.zeros((0, len(self.doa_list)), device=self.device)
        return torch.cat(out, dim=0)

    def apply_to_template(self, template, num_active_freq: int, duration_overlap: float, num_fft_bin: int,
                          snr_db, generator: torch.Generator | None = None, num_sources: int = 0) -> torch.Tensor:
        """Simulation harness + sliding-frame beamforming
        (micloc/music_beamformer.py:263-335): :func:`received_signal`
        (float64 on ``device``) with AWGN at ``snr_db`` (None: none) from
        ``generator`` (None: seeded from NumPy's global RNG)."""
        time_temp, sig_temp, doa_temp = template
        time_temp = np.asarray(time_temp, dtype=np.float64)
        time_in = np.arange(time_temp.min(), time_temp.max(), step=1.0 / self.fs)
        sig_in = np.interp(time_in, time_temp, np.asarray(sig_temp, dtype=np.float64))
        doa_in = (float(doa_temp) if np.ndim(doa_temp) == 0
                  else np.interp(time_in, time_temp, np.asarray(doa_temp, dtype=np.float64)))
        if generator is None and snr_db is not None:
            generator = torch.Generator(self.device).manual_seed(int(np.random.randint(0, 2**31 - 1)))
        f64 = dict(dtype=torch.float64, device=self.device)
        sig = received_signal(self.geometry, torch.as_tensor(time_in, **f64), torch.as_tensor(sig_in, **f64),
                              torch.as_tensor(doa_in, **f64), snr_db=snr_db, generator=generator, fs=self.fs)
        return self.apply_to_signal(sig, num_active_freq, duration_overlap, num_fft_bin, num_sources)
