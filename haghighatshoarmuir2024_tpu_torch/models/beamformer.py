"""Hilbert (STHT) beamformer (counterpart of
``haghighatshoarmuir2024_tpu/models/beamformer.py``; reference:
micloc/beamformer.py:26-292).

Design: per DoA of the grid, the template's delayed copies → STHT → the
covariance of the analytic signal past its transient; then per DoA the top
eigenvector, or with interference removal the top generalized eigenvector
against the other DoAs' summed covariance with diagonal loading.  The grid
is a batch axis taken ``design_chunk`` DoAs at a time (the JAX package's
``chunked_vmap``), so a chunk's (chunk, T, M) complex64 signals stay a few
tens of MB.  The reference computes the design's bandpass and never uses it
(micloc/beamformer.py:136-150): the covariance is of the unfiltered analytic
signal, and the bandpass runs only in :meth:`Beamformer.apply_to_signal`.

Apply: STHT → order-2 bandpass by ``iir_filter(method="scan")``, the
sequential recurrence JAX runs there → ``matmul(sig_h, bf.conj())``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, resolve_device
from ..ops.fir import full_fp32
from ..ops.iir import butter_bandpass, iir_filter
from ..ops.interp import delayed_copies, received_signal, resample_to_fs
from ..ops.linalg import generalized_top_eigvec, top_eigvec_psd
from ..ops.stht import stht, stht_kernel


def analytic(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """The STHT analytic signal ``roll(x, K//2) + 1j·FIR(kernel, x)`` along
    dim 0 of real ``x``, complex64."""
    inphase, quad = stht(x.to(torch.float32), kernel)
    return torch.complex(inphase, quad)


def bf_from_covs_interference(cov: torch.Tensor) -> torch.Tensor:
    """(G, M, M) covariances → (G, M) generalized-eigenproblem designs
    against the summed covariance of all DoAs, loaded by a tenth of its
    mean diagonal (JAX ``beamformer.py:64-77``; micloc/beamformer.py:165-190)."""
    cov_sum = cov.sum(dim=0)
    loading = torch.diagonal(cov_sum).real.mean() / 10.0
    cov_sum = cov_sum + loading * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return generalized_top_eigvec(cov, cov_sum - cov)


class Beamformer:
    """Super-resolution Hilbert beamformer (micloc/beamformer.py:26-292)
    computing on ``device``: the card by default, the CPU with
    ``device="cpu"``."""

    def __init__(self, geometry: ArrayGeometry, kernel_duration: float, freq_range, fs: float = FS,
                 design_chunk: int = 64, device=None):
        self.geometry = geometry
        self.kernel_duration = kernel_duration
        self.fs = fs
        self.design_chunk = int(design_chunk)
        self.device = resolve_device(device)
        self.kernel = stht_kernel(int(fs * kernel_duration))
        freq_range = np.asarray(freq_range, dtype=np.float64)
        if len(freq_range) != 2 or freq_range[0] > freq_range[1]:
            raise ValueError("freq_range should be a vector consisting of two frequencies f_low < f_high!")
        self.freq_range = freq_range
        self.bandpass_filter = butter_bandpass(2, freq_range, fs)

    @classmethod
    def from_config(cls, config, geometry: ArrayGeometry, device=None):
        """From a :class:`~haghighatshoarmuir2024_tpu_torch.config.BeamformerConfig`."""
        return cls(geometry=geometry, kernel_duration=config.kernel_duration, freq_range=config.freq_range,
                   fs=config.fs, design_chunk=config.design_chunk, device=device)

    # ------------------------------------------------------------------ design
    def design_covariances(self, sig_temp: torch.Tensor, t0: float, delays: torch.Tensor) -> torch.Tensor:
        """(G, M, M) complex64 covariances ``Xᴴ X / n`` of the analytic
        signals of the G DoAs of ``delays`` (G, M), past the first
        ``min(K, T // 2)`` samples (JAX ``_design_covariances``,
        ``beamformer.py:32-61``; micloc/beamformer.py:113-150)."""
        full_fp32()
        T = sig_temp.shape[0]
        stable = min(len(self.kernel), T // 2)
        covs = []
        for s in range(0, delays.shape[0], self.design_chunk):
            X = delayed_copies(sig_temp, t0, delays[s:s + self.design_chunk], self.fs).transpose(0, 1)
            Xs = analytic(X, self.kernel)[stable:]  # (n, g, M)
            covs.append(torch.einsum("tgm,tgn->gmn", Xs.conj(), Xs) / Xs.shape[0])
        return torch.cat(covs)

    def design_from_template(self, template: Tuple[np.ndarray, np.ndarray], doa_list,
                             interference_removal: bool = False):
        """Beamforming vectors for each DoA of ``doa_list``: ``(bf_mat (M, G),
        cov (G, M, M))``, complex64 on ``device`` (micloc/beamformer.py:73-192)."""
        time_temp, sig_temp = resample_to_fs(*template, self.fs)
        delays = self.geometry.delays_np(np.asarray(doa_list, dtype=np.float64), normalized=True)
        cov = self.design_covariances(torch.as_tensor(sig_temp, dtype=torch.float32, device=self.device),
                                      float(np.float32(time_temp[0])),
                                      torch.as_tensor(delays, dtype=torch.float32, device=self.device))
        bf = bf_from_covs_interference(cov) if interference_removal else top_eigvec_psd(cov)
        return bf.T, cov

    # ------------------------------------------------------------------- apply
    def apply_to_signal(self, bf_mat, sig_in) -> torch.Tensor:
        """STHT → bandpass → beamforming matmul (micloc/beamformer.py:260-292):
        ``sig_in`` (T, M), or a batch (B, T, M) of frames filtered in one
        scan, → complex64 (T, G) or (B, T, G)."""
        bf_mat = torch.as_tensor(bf_mat, device=self.device).to(torch.complex64)
        x = torch.as_tensor(sig_in, device=self.device).to(torch.float32)
        num_mic = bf_mat.shape[0]
        if x.dim() not in (2, 3) or x.shape[-1] != num_mic:
            raise ValueError(f"number of channels in the input signal {x.shape[-1]} should be the same "
                             f"as the number of microphones {num_mic}!")
        xt = x.movedim(-2, 0)  # time first
        b, a = self.bandpass_filter
        sig_h = iir_filter(b, a, analytic(xt, self.kernel), axis=0, method="scan")
        full_fp32()
        return torch.matmul(sig_h, bf_mat.conj()).movedim(0, -2)

    def apply_to_template(self, bf_mat, template, snr_db, generator: torch.Generator | None = None):
        """Simulation harness: the template resampled to ``fs``, delayed
        copies (:func:`received_signal`, float64 on ``device``) + AWGN at
        ``snr_db`` (None: none) → :meth:`apply_to_signal`
        (micloc/beamformer.py:194-258).  The noise comes from ``generator``;
        None seeds one from NumPy's global RNG, as the reference draws."""
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
        return self.apply_to_signal(bf_mat, sig)
