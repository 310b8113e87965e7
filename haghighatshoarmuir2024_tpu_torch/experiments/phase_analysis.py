"""Instantaneous-phase analyses, the port's twin of
``experiments/phase_analysis.py`` (the numbers of the paper's small figures
paper_plots/phase_plot.py, random_phase.py and chirp_phase_plot.py): the
instantaneous frequency of the STHT analytic signal (a 10 ms kernel,
float32 on the device) of a two-tone sum, of band-limited noise (white noise
through the order-2 Butterworth bandpass, ``iir_filter(method="scan")``),
and of a 1600-2000 Hz chirp against its programmed sweep.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.phase_analysis [--device cpu]

Prints one JSON object with the JAX twin's keys.  The figures are not
ported.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import resolve_device
from ..ops.iir import butter_bandpass, iir_filter
from ..ops.stht import stht, stht_kernel
from .common import FS, arg_parser, chirp_template


def _analytic(sig: np.ndarray, dev: torch.device, kernel_duration: float = 10e-3):
    """The STHT analytic signal of ``sig`` (float32 on ``dev``) as a host
    complex array, and the kernel length."""
    ker = stht_kernel(int(FS * kernel_duration))
    x = torch.as_tensor(np.array(sig)[:, None], dtype=torch.float32, device=dev)
    inphase, quad = stht(x, ker)
    return torch.complex(inphase, quad)[:, 0].cpu().numpy(), len(ker)


def _f_inst(a: np.ndarray) -> np.ndarray:
    return np.diff(np.unwrap(np.angle(a))) / (2 * np.pi) * FS


def overlapping_exponentials(dev) -> dict:
    """A two-tone sum: its instantaneous frequency stays between the two
    tones, pulled toward the stronger."""
    t = np.arange(0, 0.25, 1 / FS)
    f1, f2 = 1700.0, 1900.0
    a, K = _analytic(np.sin(2 * np.pi * f1 * t) + 0.5 * np.sin(2 * np.pi * f2 * t), dev)
    f_inst = _f_inst(a[2 * K: -2 * K])
    return {"f_inst_mean": float(f_inst.mean()),
            "f_inst_in_band_frac": float(np.mean((f_inst > f1 - 150) & (f_inst < f2 + 150)))}


def random_wideband_phase(dev, seed: int = 0) -> dict:
    """Band-limited noise: the phase increments gather around the band
    centre."""
    rng = np.random.default_rng(seed)
    b, a = butter_bandpass(2, (1600, 1900), FS)
    noise = torch.as_tensor(rng.standard_normal(int(round(0.25 * FS))), dtype=torch.float32, device=dev)
    return wideband_stats(iir_filter(b, a, noise, axis=0, method="scan").cpu().numpy(), dev)


def wideband_stats(sig: np.ndarray, dev) -> dict:
    """The median and interquartile range of the instantaneous frequency of
    band-limited noise ``sig``."""
    an, K = _analytic(sig, dev)
    f_inst = _f_inst(an[2 * K: -2 * K])
    return {"f_inst_median": float(np.median(f_inst)),
            "f_inst_iqr": float(np.percentile(f_inst, 75) - np.percentile(f_inst, 25))}


def chirp_phase(dev) -> dict:
    """A chirp: the recovered instantaneous frequency tracks the sweep."""
    t, sig = chirp_template((1600.0, 2000.0), 0.25)
    a, K = _analytic(sig, dev)
    sl = slice(2 * K, len(t) - 2 * K)
    f_inst = _f_inst(a[sl])
    err = np.abs(f_inst - (1600.0 + (2000.0 - 1600.0) * (t[sl][:-1] / t[-1])))
    return {"freq_track_mae_hz": float(err.mean()), "freq_track_p95_hz": float(np.percentile(err, 95))}


def run(device=None) -> dict:
    dev = resolve_device(device)
    return {"overlapping_exponentials": overlapping_exponentials(dev),
            "random_wideband_phase": random_wideband_phase(dev), "chirp_phase": chirp_phase(dev)}


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)  # --quick: the same run, which takes seconds
    res = {"experiment": "phase_analysis", "results": run(args.device)}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
