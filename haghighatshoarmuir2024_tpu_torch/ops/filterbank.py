"""Butterworth filterbank coefficients (counterpart of
``haghighatshoarmuir2024_tpu/ops/filterbank.py``; micloc/filterbank.py:57-84).

The slice needs only the per-band ``(b, a)`` list; the filter is applied by
``ops.iir.iir_cumsum_blocked`` inside the encode.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .iir import butter_bandpass


class ButterworthFilterbank:
    """Order-N Butterworth bandpass bank: ``ba_list[i] = (b, a)`` of band i."""

    def __init__(self, freq_bands: List, order: int, fs: float):
        self.order = order
        self.fs = fs
        self.freq_bands = np.asarray(freq_bands, dtype=np.float64)
        if self.freq_bands.ndim == 1:
            self.freq_bands = self.freq_bands.reshape(1, -1)
        self.ba_list = [butter_bandpass(order, fb, fs) for fb in self.freq_bands]
