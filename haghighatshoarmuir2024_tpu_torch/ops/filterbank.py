"""Butterworth filterbank (counterpart of
``haghighatshoarmuir2024_tpu/ops/filterbank.py``; micloc/filterbank.py:16-84).

``ba_list`` holds each band's ``(b, a)``; :meth:`Filterbank.evolve` filters a
(T, M) signal through every band.  The encode applies its bands itself, by
``ops.iir.iir_cumsum_blocked``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .iir import butter_bandpass, iir_filter


class Filterbank:
    """``evolve(sig (T, M)) -> (F, T, M)`` (micloc/filterbank.py:16-54)."""

    def __init__(self, ba_list: List):
        self.ba_list = [(np.asarray(b), np.asarray(a)) for b, a in ba_list]

    def evolve(self, sig_in: torch.Tensor, method: str = "scan") -> torch.Tensor:
        """Each band's ``iir_filter(method=method)`` along dim 0 of
        ``sig_in`` ((T,) or (T, M)), stacked band-major, on its device."""
        if sig_in.dim() == 1:
            sig_in = sig_in.reshape(-1, 1)
        return torch.stack([iir_filter(b, a, sig_in, axis=0, method=method) for b, a in self.ba_list])

    def __call__(self, *args, **kwargs):
        return self.evolve(*args, **kwargs)

    def __len__(self):
        return len(self.ba_list)


class ButterworthFilterbank(Filterbank):
    """Order-N Butterworth bandpass bank (micloc/filterbank.py:57-84)."""

    def __init__(self, freq_bands: List, order: int, fs: float):
        self.order = order
        self.fs = fs
        self.freq_bands = np.asarray(freq_bands, dtype=np.float64)
        if self.freq_bands.ndim == 1:
            self.freq_bands = self.freq_bands.reshape(1, -1)
        super().__init__([butter_bandpass(order, fb, fs) for fb in self.freq_bands])
