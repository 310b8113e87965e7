"""What the port's experiment harnesses share (the part of
``experiments/common.py`` they need): the sample rate, the tone template,
the reference's SNR sweep and the MAE summary."""
from __future__ import annotations

import numpy as np

FS = 48_000


def sinusoid_template(freq: float, duration: float, fs: float = FS):
    t = np.arange(0, duration, 1 / fs)
    return t, np.sin(2 * np.pi * freq * t)


def snr_sweep_config() -> np.ndarray:
    """The reference's sweep: SNR in [-10, 20] dB, 11 points
    (paper_plots/target_localization.py:210-300)."""
    return np.linspace(-10, 20, 11)


def summarize(result) -> dict:
    return {
        "snr_db": [float(s) for s in result["snr_db"]],
        "mae_deg": [float(np.rad2deg(m)) for m in result["mae"]],
        "median_deg": [float(np.rad2deg(m)) for m in result["median"]],
    }
