"""Monotone (isotonic) regression by pool-adjacent-violators, numpy
(counterpart of ``haghighatshoarmuir2024_tpu/utils/isotonic.py``): the
closed-form L2 fit of the reference's cvxpy ``approx_decreasing``
(paper_plots/target_snn_localization.py:66-84)."""
from __future__ import annotations

import numpy as np


def isotonic_increasing(y: np.ndarray, weights=None) -> np.ndarray:
    """L2-optimal non-decreasing fit via pool-adjacent-violators."""
    y = np.asarray(y, dtype=np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights, dtype=np.float64)
    vals: list = []
    wts: list = []
    cnts: list = []
    for yi, wi in zip(y, w):
        vals.append(yi)
        wts.append(wi)
        cnts.append(1)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v2, w2, c2 = vals.pop(), wts.pop(), cnts.pop()
            v1, w1, c1 = vals.pop(), wts.pop(), cnts.pop()
            wt = w1 + w2
            vals.append((v1 * w1 + v2 * w2) / wt)
            wts.append(wt)
            cnts.append(c1 + c2)
    return np.repeat(np.asarray(vals, dtype=np.float64), cnts)


def approx_decreasing(y: np.ndarray, weights=None) -> np.ndarray:
    """L2-optimal non-increasing fit (the reference helper's contract)."""
    return -isotonic_increasing(-np.asarray(y, dtype=np.float64), weights)
