"""Benchmark statistics, numpy (counterpart of
``haghighatshoarmuir2024_tpu/utils/stats.py``): the ``analyze`` procedure
of the reference's live benchmark
(paper_plots/snn_localization_benchmark.py:595-660): a windowed median with
jump rejection, the MAE against the run's median, robust spreads."""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_window(source: np.ndarray, win_length: int) -> np.ndarray:
    """Sliding windows (len(source) − win_length, win_length)
    (snn_localization_benchmark.py:600-606)."""
    source = np.asarray(source, dtype=np.float64)
    n = source.size - win_length
    ret = np.empty((n, win_length))
    for w in range(win_length):
        ret[:, w] = source[w: -(win_length - w)]
    return ret


def window_median(source: np.ndarray, window_length: int, reject_jump: float) -> np.ndarray:
    """Windowed median with jump rejection (snn_localization_benchmark.py:608-619).

    The reference computes ``np.abs(diff > reject_jump)``, the absolute
    value of a boolean: the rejection is one-sided (``diff > reject_jump``).
    Kept so that recorded runs re-analyze to the same numbers."""
    sw = make_window(source, window_length)
    out = np.empty(sw.shape[0])
    for i in range(sw.shape[0]):
        w = sw[i, :].copy()
        diff = w - np.median(w)
        w[np.abs(diff > reject_jump)] = np.nan
        out[i] = np.nanmedian(w)
    return out


def mae(source: np.ndarray, target) -> float:
    return float(np.mean(np.abs(np.asarray(source) - target)))


def analyze_doa_samples(data: np.ndarray, window_length: int = 25, reject_jump: float = 20.0) -> Dict[str, float]:
    """The statistics of a run of DoA samples (degrees), as
    snn_localization_benchmark.py:621-649 prints them."""
    data = np.asarray(data, dtype=np.float64)
    med = np.median(data)
    post = window_median(data, window_length, reject_jump)
    medad = np.median(np.abs(data - med))
    mad = np.mean(np.abs(data - med))
    return {
        "doa_mae_postprocessed": mae(post, med),
        "mean": float(np.mean(data)),
        "std": float(np.std(data)),
        "median": float(med),
        "mean_abs_deviation": float(mad),
        "robust_std": float(medad * np.sqrt(np.pi / 2)),
        "mean_robust_std": float(mad * np.sqrt(np.pi / 2)),
    }
