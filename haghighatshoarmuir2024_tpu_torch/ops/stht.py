"""Short-Time Hilbert Transform (counterpart of
``haghighatshoarmuir2024_tpu/ops/stht.py``; reference:
micloc/beamformer.py:47-52,131-134).

The analytic signal is ``roll(x, K//2) + 1j·FIR(kernel, x)``; it is returned
as its two real parts, which is all the encode consumes.  :func:`stht_stream`
is the carried-state form of the streaming runtime
(``haghighatshoarmuir2024_tpu/runtime/streaming.py:164-172``).
"""
from __future__ import annotations

import numpy as np
import torch

from .fir import fir_block_matmul


def stht_kernel(kernel_length: int) -> np.ndarray:
    """FIR Hilbert kernel of length ``kernel_length`` (host-side, float64):
    ``np.fft.fftshift(np.imag(scipy.signal.hilbert(impulse)))``
    (micloc/beamformer.py:48-52)."""
    n = int(kernel_length)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    analytic = np.fft.ifft(h.astype(complex))
    return np.fft.fftshift(np.imag(analytic))


def stht(x: torch.Tensor, kernel: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(in-phase, quadrature) parts of the STHT along dim 0 of ``x``.

    The in-phase part is ``x`` rolled by the kernel's group delay (the
    reference's wrap-around ``np.roll``); the quadrature part is the causal
    FIR in the 512-sample blocked-Toeplitz form the JAX package runs on the
    TPU (``stht(method="blockmm")``)."""
    K = len(kernel)
    inphase = torch.roll(x, K // 2, dims=0)
    quad = fir_block_matmul(kernel, x)
    return inphase, quad


def stht_stream(x: torch.Tensor, fir_tail: torch.Tensor, delay_line: torch.Tensor,
                kernel: np.ndarray):
    """One chunk of the streaming STHT along dim 0 of ``x`` (Tc, ...).

    The quadrature FIR runs over ``cat(fir_tail, x)`` and keeps its last Tc
    outputs, so the K−1 samples of history make the chunk seams exact; the
    in-phase branch is a true K//2-sample delay line (the offline
    :func:`stht`'s ``roll`` wraps the signal's end into its start instead).

    Args:
        fir_tail: (K−1, ...) the stream's last K−1 samples.
        delay_line: (K//2, ...) the in-phase delay line.

    Returns:
        ``(inphase, quad, new_fir_tail, new_delay_line)``.
    """
    K = len(kernel)
    Tc = x.shape[0]
    ext = torch.cat([fir_tail, x], dim=0)
    quad = fir_block_matmul(kernel, ext)[K - 1:]
    line = torch.cat([delay_line, x], dim=0)
    return line[:Tc], quad, ext[ext.shape[0] - (K - 1):], line[Tc:]
