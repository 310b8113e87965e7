"""What the port's experiment harnesses share (the port's copy of
``experiments/common.py``): the sample rate, the templates, the beam
pattern and its -3 dB width, the reference's SNR sweep, the MAE summary,
and the command line every harness takes.  Figures are not ported."""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.xylo import Demo
from ..models.xylo.multiband import jittered_sinusoid_template  # noqa: F401  (a template of the harnesses)

FS = 48_000
SPEECH_FLAC = "/root/reference/paper_plots/84-121123-0020.flac"


# ------------------------------------------------------------------ templates
def sinusoid_template(freq: float, duration: float, fs: float = FS):
    t = np.arange(0, duration, 1 / fs)
    return t, np.sin(2 * np.pi * freq * t)


def chirp_template(freq_range, duration: float, fs: float = FS):
    """A linear chirp across the band (paper_plots/target_snn_localization.py:126-134)."""
    f_min, f_max = freq_range
    t = np.arange(0, duration, 1 / fs)
    period = t[-1]
    freq_inst = f_min + (f_max - f_min) * (t % period) / period
    return t, np.sin(2 * np.pi * np.cumsum(freq_inst) / fs)


def _bandpass_host(x: np.ndarray, freq_range, fs: float) -> np.ndarray:
    """Order-2 Butterworth bandpass of a host float64 signal, by the port's
    sequential scan (JAX runs ``iir_filter(method="scan")`` there)."""
    from ..ops.iir import butter_bandpass, iir_filter

    b, a = butter_bandpass(2, freq_range, fs)
    return iir_filter(b, a, torch.as_tensor(np.asarray(x, np.float64)), axis=0, method="scan").numpy()


def bandlimited_noise_template(freq_range, duration: float, fs: float = FS, seed: int = 0):
    """White noise filtered to the band (paper_plots/array_resolution.py:194-286)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0, duration, 1 / fs)
    return t, _bandpass_host(rng.standard_normal(len(t)), freq_range, fs)


def speech_template(duration: Optional[float] = None, fs: float = FS, segment: int = 0):
    """The LibriSpeech sample of the reference's speech benchmarks
    (paper_plots/84-121123-0020.flac, target_localization.py:146-152), read
    by the port's ``io/flac`` when the file is there, else a synthetic
    speech-like signal (a formant-filtered pulse train with syllabic
    modulation), as JAX ``common.py:71-128``.

    When the sample is longer than ``duration``, ``segment=k`` takes its
    (k+1)-th highest-energy window of ``duration`` seconds that overlaps
    none taken before (k = 0: the reference's best window).  Peak 1."""
    sig = None
    if os.path.exists(SPEECH_FLAC):
        try:
            from ..io.flac import read_flac

            data, file_fs = read_flac(SPEECH_FLAC)
            sig = data[:, 0] if data.ndim > 1 else data
            if file_fs != fs:
                t_old = np.arange(len(sig)) / file_fs
                sig = np.interp(np.arange(0, t_old[-1], 1 / fs), t_old, sig)
        except Exception:
            sig = None
    if sig is None:
        rng = np.random.default_rng(0)
        t = np.arange(0, duration or 4.0, 1 / fs)
        f0 = 120 * (1 + 0.1 * np.sin(2 * np.pi * 2.3 * t))
        glottal = np.sin(2 * np.pi * np.cumsum(f0) / fs) ** 9
        syllable = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, np.pi)))
        sig = _bandpass_host(glottal * syllable, (300, 3400), fs)
    if duration is not None and len(sig) > int(duration * fs):
        # the highest-energy window, not the head: the recording opens with
        # silence, and a silent template synthesizes a zero array signal
        n = int(duration * fs)
        e = np.concatenate([[0.0], np.cumsum(np.asarray(sig, np.float64) ** 2)])
        win = e[n:] - e[:-n]
        start = 0
        for _ in range(segment + 1):
            if not np.any(np.isfinite(win)) or np.nanmax(win) <= 0:
                raise ValueError(f"sample has no {segment + 1} disjoint windows")
            start = int(np.nanargmax(win))
            win[max(0, start - n + 1):start + n] = -np.inf  # every window overlapping the one taken
        sig = sig[start:start + n]
    t = np.arange(len(sig)) / fs
    return t, sig / (np.abs(sig).max() + 1e-12)


# --------------------------------------------------------------- beam pattern
def beam_pattern(bf_mat, complex_fold: bool = False) -> np.ndarray:
    """The correlation matrix ``|bfᴴ bf|`` (G, G) on the host: the beam
    patterns of paper_plots/array_resolution.py; ``complex_fold`` first
    re-folds a 2M-real SNN design into M complex rows
    (array_resolution_snn.py:156-160)."""
    bf = torch.as_tensor(bf_mat)
    if complex_fold:
        m = bf.shape[0] // 2
        bf = torch.complex(bf[:m], bf[m:])
    from ..ops.fir import full_fp32

    full_fp32()
    return torch.abs(bf.conj().T @ bf).cpu().numpy()


def beamwidth_3db(pattern_row: np.ndarray, doa_list: np.ndarray) -> float:
    """-3 dB width (degrees) of one beam pattern row."""
    p = pattern_row / pattern_row.max()
    frac = np.mean(p >= (10 ** (-3 / 20)))
    return float(frac * (doa_list.max() - doa_list.min()) * 180 / np.pi)


def widths(pattern: np.ndarray, doa_list: np.ndarray) -> dict:
    """The mean and max -3 dB width over a pattern's rows, as the
    array-resolution harnesses report them."""
    w = [beamwidth_3db(row, doa_list) for row in pattern]
    return {"beamwidth_3db_deg_mean": float(np.mean(w)), "beamwidth_3db_deg_max": float(np.max(w))}


# ------------------------------------------------------------ MC sweep driver
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


def mc_sweep(profile, grid, geometry, t, sig, num_sims: int, seed: int = 0, device=None, snr_db_vec=None,
             delay_sign: int = 1, draws=None) -> dict:
    """The MC sweep (``parallel.monte_carlo_sweep``'s dict) of the estimator
    ``grid[argmax(profile(frames))]``, ``profile`` (B, T, M) → (B, G), on
    trials of the template ``(t, sig)``; the reference's 11 SNRs unless
    ``snr_db_vec`` is given."""
    from ..geometry import resolve_device
    from ..parallel import make_trial_fn, monte_carlo_sweep

    dev = resolve_device(device)
    grid_t = torch.as_tensor(np.asarray(grid), device=dev)
    trial = make_trial_fn(geometry, t, sig, lambda f: grid_t[profile(f).argmax(dim=-1)], FS,
                          delay_sign=delay_sign, device=dev)
    snrs = snr_sweep_config() if snr_db_vec is None else snr_db_vec
    return monte_carlo_sweep(trial, snrs, num_sims, seed, draws=draws)


def calibrated_demo(num_grid: int, duration: float = 0.25, fs: int = FS, freq_band=(1600, 1900),
                    device=None) -> Demo:
    """The flagship's Xylo model (bench.py's array, a 10 ms STHT kernel,
    bipolar spikes) on a ``num_grid``-point grid at ``fs``, frames of
    ``duration`` s in ``freq_band``, its matched profiles calibrated."""
    demo = Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[list(freq_band)],
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=duration, kernel_duration=10e-3,
                bipolar_spikes=True, fs=fs, device=device)
    demo.calibrate_profiles()
    return demo


def sync(dev: torch.device) -> None:
    """Wait for the card, where ``dev`` is one, before a host clock is read."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def folded_deg(est, true) -> np.ndarray:
    """The reference's folded error ``arcsin|sin(est − true)|`` in degrees."""
    return np.rad2deg(np.arcsin(np.abs(np.sin(np.asarray(est) - np.asarray(true)))))


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """The options every harness takes: ``--quick`` for a small run and
    ``--device`` (the card unless ``cpu``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="a small run: few trials, a short frame, a coarse grid")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap
