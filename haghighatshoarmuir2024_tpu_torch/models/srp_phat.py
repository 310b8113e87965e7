"""SRP-PHAT: GCC-PHAT steered-response-power DoA (counterpart of
``haghighatshoarmuir2024_tpu/models/srp_phat.py``).

The classical baseline beside the Hilbert, SNN and MUSIC families.  The
steered power is evaluated in the frequency domain as one contraction:

    P(θ) = Σ_pairs Σ_bins Re[ R_p(f) · exp(+j 2π f (d_i(θ) − d_j(θ))) ] / P

with the PHAT-whitened cross-spectra ``R_p = X_i X_j* / |X_i X_j*|`` of the
in-band rFFT bins of one frame and all mic pairs i < j.  The steering is
kept as real cos/sin planes (P·F, G) float32, and ``Re{Rᵀ S}`` runs as two
float32 matmuls with TF32 off.

Synthesis convention: the steering is physical, like MUSIC's: it matches
audio propagated as ``s(t − delay)`` (``signal_from_template(...,
delay_sign=-1)`` or ``received_signal``); plus-convention audio mirrors the
estimates by 180°.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FS
from ..geometry import resolve_device
from ..ops.fir import full_fp32
from ..ops.interp import signal_from_template


class SRPPHAT:
    """GCC-PHAT steered-response-power localizer on a DoA grid, one rFFT per
    ``frame_duration`` frame, computing on ``device``: the card by default,
    the CPU with ``device="cpu"``."""

    def __init__(self, geometry, freq_range, doa_list, fs: float = FS, frame_duration: float = 0.25,
                 device=None):
        self.device = resolve_device(device)
        self.geometry = geometry
        self.freq_range = [float(freq_range[0]), float(freq_range[1])]
        if self.freq_range[0] >= self.freq_range[1]:
            raise ValueError("freq_range must be increasing")
        self.doa_list = np.asarray(doa_list, np.float64)
        self.fs = float(fs)
        self.T = int(round(frame_duration * fs))
        M = len(geometry)
        self._pairs = [(i, j) for i in range(M) for j in range(i + 1, M)]
        freqs = np.fft.rfftfreq(self.T, 1.0 / self.fs)
        self._bins = np.flatnonzero((freqs >= self.freq_range[0]) & (freqs <= self.freq_range[1]))
        if self._bins.size == 0:
            raise ValueError("freq_range contains no FFT bins at this frame size")
        # steering phases (P, F, G) of exp(+j 2π f τ_p(θ)), as cos/sin planes
        d = geometry.delays_np(self.doa_list, normalized=True).T  # (M, G)
        tau = np.stack([d[i] - d[j] for (i, j) in self._pairs])  # (P, G)
        phase = 2.0 * np.pi * freqs[self._bins][None, :, None] * tau[:, None, :]
        G = len(self.doa_list)
        as_dev = lambda v, dt: torch.as_tensor(v, dtype=dt, device=self.device)
        self._steer_re = as_dev(np.cos(phase).astype(np.float32).reshape(-1, G), torch.float32)
        self._steer_im = as_dev(np.sin(phase).astype(np.float32).reshape(-1, G), torch.float32)
        self._bins_t = as_dev(self._bins, torch.int64)
        self._pair_i = as_dev([p[0] for p in self._pairs], torch.int64)
        self._pair_j = as_dev([p[1] for p in self._pairs], torch.int64)
        self._doa_t = as_dev(self.doa_list, torch.float64)

    def apply_to_signal(self, sig_in) -> torch.Tensor:
        """(T, M) or (B, T, M) audio → (G,) or (B, G) angular power
        (JAX ``srp_phat.py:98-127``)."""
        x = torch.as_tensor(sig_in, device=self.device).to(torch.float32)
        X = torch.fft.rfft(x, dim=-2)  # (..., Tf, M)
        Xb = X[..., self._bins_t, :]  # (..., F, M)
        cross = Xb[..., self._pair_i] * Xb[..., self._pair_j].conj()  # (..., F, P)
        R = cross / torch.clamp(cross.abs(), min=1e-12)  # PHAT whitening
        Rf = R.transpose(-1, -2).reshape(*R.shape[:-2], -1)  # (..., P·F), pair-major
        full_fp32()
        P = torch.matmul(Rf.real, self._steer_re) - torch.matmul(Rf.imag, self._steer_im)
        return P / len(self._pairs)

    def estimate(self, sig_in) -> torch.Tensor:
        """DoA estimate(s): the argmax of the steered power, float64."""
        return self._doa_t[torch.argmax(self.apply_to_signal(sig_in), dim=-1)]

    def apply_to_template(self, template, snr_db, generator: torch.Generator | None = None) -> torch.Tensor:
        """(t, sig, doa) template → (G,) angular power, as the other
        families' harness: the array signal of ``signal_from_template``
        (JAX ``srp_phat.py:136-152`` calls it with its default plus
        convention) in float32 on ``device``, plus white noise at ``snr_db``
        drawn from ``generator`` when one is given."""
        t, sig, doa = template
        f32 = dict(dtype=torch.float32, device=self.device)
        x = signal_from_template(self.geometry, torch.as_tensor(t, **f32), torch.as_tensor(sig, **f32),
                                 doa, fs=self.fs)
        if generator is not None:
            sigma = torch.sqrt(torch.mean(x**2) / 10.0 ** (float(snr_db) / 10.0))
            x = x + sigma * torch.randn(x.shape, generator=generator, **f32)
        return self.apply_to_signal(x)
