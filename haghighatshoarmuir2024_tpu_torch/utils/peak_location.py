"""Robust peak location by moving-average smoothing (counterpart of
``haghighatshoarmuir2024_tpu/utils/peak_location.py``; reference:
micloc/utils.py:84-121)."""
from __future__ import annotations

import torch

from ..geometry import as_device_tensor
from ..ops.fir import moving_average_full


def find_peak_location(sig_in, win_size: int, periodic: bool = True, device=None) -> torch.Tensor:
    """Index of the peak of each row of ``sig_in`` (..., T) after
    length-``win_size`` averaging: full-mode moving average, argmax (the
    first of equal maxima), shifted back by ``win_size // 2``, wrapped
    modulo T when ``periodic``.  Returns int64 indices of shape (...).  A
    ``sig_in`` that is not a tensor lands on ``device``, the card unless the
    caller passes ``"cpu"``; a tensor stays on its device."""
    sig_in = as_device_tensor(sig_in, device)
    if sig_in.dim() < 1:
        raise ValueError("input signal should be at least 1-dim!")
    T = sig_in.shape[-1]
    if win_size % 2 != 1:
        raise ValueError("averaging window size should be odd to not create confusion in peak index!")
    if win_size > T // 2:
        raise ValueError("size of averaging window is larger than half the length of input signal!")
    index = torch.argmax(moving_average_full(sig_in, win_size), dim=-1) - win_size // 2
    return index % T if periodic else index
