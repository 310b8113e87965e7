"""IIR approximation of the Hilbert transform kernel (counterpart of
``haghighatshoarmuir2024_tpu/ops/hilbert_iir.py``; reference:
tests/test_hilbert_iir.py:18-80).

The fit is a small least squares on the host in numpy and scipy; the
analytic signal runs the fitted filter with the port's sequential IIR scan.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .iir import iir_filter
from .stht import stht_kernel


def fit_hilbert_iir(fs: float, kernel_duration: float, deg_MA: int = 6,
                    deg_AR: int = 6) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares ``(b, a)`` fit to the causal half of the Hilbert FIR
    kernel by the reference's Hankel construction (its
    tests/test_hilbert_iir.py:30-52): ``min ‖y − (MA·b + AR·ā)‖`` over
    Hankel matrices of the impulse and of the target half.

    Returns ``(b, a, rel_err)``: the coefficients and the relative L2 error
    of the fitted impulse response against the target half."""
    from scipy.linalg import hankel
    from scipy.signal import lfilter

    impulse_len = int(kernel_duration * fs)
    impulse = np.zeros(impulse_len)
    impulse[0] = 1.0
    # the reference fits imag(hilbert(impulse)) without fftshift and keeps
    # the first (causal) half; the STHT kernel with its fftshift undone
    kerh = np.fft.ifftshift(stht_kernel(impulse_len))
    kerh = kerh[: len(kerh) // 2]
    L = len(kerh)
    inp, out = impulse[:L], kerh[:L]

    hankel_MA = hankel(inp[::-1])[::-1, :deg_MA]
    hankel_AR = hankel(out[::-1])[::-1, 1: deg_AR + 1]
    y = hankel(out[::-1])[::-1, 0]
    solution = np.linalg.lstsq(np.concatenate([hankel_MA, hankel_AR], axis=1), y, rcond=None)[0]
    b = solution[:deg_MA]
    a = np.asarray([1.0, *(-solution[deg_MA:])])
    est = lfilter(b, a, inp)
    rel_err = float(np.linalg.norm(out - est) / min(np.linalg.norm(out), np.linalg.norm(est)))
    return b, a, rel_err


def hilbert_iir_analytic(sig: torch.Tensor, b: np.ndarray, a: np.ndarray, group_delay: int,
                         axis: int = 0) -> torch.Tensor:
    """The analytic signal with the fitted IIR as its quadrature branch
    (``iir_filter(method="scan")``) and the in-phase part rolled by the
    filter's group delay, as the STHT rolls it (micloc/beamformer.py:131-134):
    a complex tensor of ``sig``'s shape."""
    quad = iir_filter(b, a, sig, axis=axis, method="scan")
    return torch.complex(torch.roll(sig, group_delay, dims=axis), quad)
