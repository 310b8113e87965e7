"""Robustness to array imperfections, the port's twin of
``experiments/mismatch_robustness.py`` (beyond the reference, which never
perturbs its array): the synthesis uses a perturbed array (a per-mic gain
spread, log-normal with a std of 0-4 dB, or a Gaussian mic position error
of 0-5 mm, redrawn per trial) while the design keeps the nominal one; a
1750 Hz tone at 10 dB, a random DoA per trial, the folded MAE of the
Hilbert beamformer and of the quantized Xylo pipeline (matched estimator).

    python -m haghighatshoarmuir2024_tpu_torch.experiments.mismatch_robustness \\
        [--quick] [--trials N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The DoAs, gains and
positions come from ``numpy.random.default_rng(seed)``, as in JAX; the
white noise from a ``torch.Generator`` seeded with ``seed`` (JAX: its keys),
the same for every value of a sweep.  A value's trials go through one
Hilbert batch and one ``Demo.rates_batch`` (on the card: K1, K2, the pack
and K3 once) with the matched profile.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import ArrayGeometry, CenterCircularArray, resolve_device
from ..models.beamformer import Beamformer
from ..models.xylo import Demo
from ..ops.interp import signal_from_template
from ..parallel import folded_angle_error
from .common import FS, arg_parser, calibrated_demo

SNR_DB = 10.0
GAIN_DB = [0.0, 1.0, 2.0, 4.0]  # per-mic gain spread (std, dB)
POS_MM = [0.0, 1.0, 2.0, 5.0]  # mic position error (std, mm)
FREQ_RANGE = (1600.0, 1900.0)


def _perturbed_geometry(geometry, rng, sigma_pos_m: float) -> ArrayGeometry:
    """The nominal polar mic positions plus a Gaussian XY error."""
    x = geometry.r_vec * np.cos(geometry.theta_vec)
    y = geometry.r_vec * np.sin(geometry.theta_vec)
    x = x + rng.normal(0, sigma_pos_m, x.shape)
    y = y + rng.normal(0, sigma_pos_m, y.shape)
    r = np.maximum(np.hypot(x, y), 1e-4)  # ArrayGeometry requires positive radii
    return ArrayGeometry(r, np.arctan2(y, x), speed=geometry.speed)


def trial_frames(kind: str, value: float, num_trials: int, seed: int = 0, duration: float = 0.25, noise=None,
                 device=None):
    """One sweep value's (num_trials, T, M) float32 frames on ``device`` and
    their DoAs: per trial (in JAX's order of draws) the DoA, then the
    perturbed positions or the gains, then the noise, standard normal
    (num_trials, T, M) unless ``noise`` is given."""
    dev = resolve_device(device)
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, duration, 1 / FS)
    tt, ss = torch.as_tensor(t), torch.as_tensor(np.sin(2 * np.pi * 1750.0 * t))
    rng = np.random.default_rng(seed)
    doa_true = rng.uniform(0, 2 * np.pi, num_trials)
    if noise is None:
        noise = torch.randn((num_trials, len(t), len(geometry)), generator=torch.Generator(dev).manual_seed(seed),
                            dtype=torch.float32, device=dev)
    noise = torch.as_tensor(noise, device=dev).to(torch.float64)
    frames = []
    for i in range(num_trials):
        g = _perturbed_geometry(geometry, rng, value * 1e-3) if kind == "pos" else geometry
        clean = signal_from_template(g, tt, ss, float(doa_true[i]), fs=FS).numpy()
        if kind == "gain":
            clean = clean * 10 ** (rng.normal(0, value, clean.shape[1]) / 20.0)[None, :]
        sigma = float(np.sqrt((clean**2).mean() / 10 ** (SNR_DB / 10)))
        frames.append((torch.as_tensor(clean, device=dev) + sigma * noise[i]).to(torch.float32))
    return torch.stack(frames), doa_true


def build(num_grid: int = 16 * 7, duration: float = 0.25, device=None):
    """The Hilbert design and the calibrated Xylo model on the nominal
    array: (bf, bf_mat, demo)."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, num_grid)
    t = np.arange(0, duration, 1 / FS)
    bf = Beamformer(geometry, kernel_duration=10e-3, freq_range=FREQ_RANGE, fs=FS, device=device)
    bf_mat, _ = bf.design_from_template((t, np.sin(2 * np.pi * 1750.0 * t)), grid)
    return bf, bf_mat, build_demo(num_grid, duration, device)


def build_demo(num_grid: int = 16 * 7, duration: float = 0.25, device=None) -> Demo:
    """The Xylo model on the nominal array, its matched profiles calibrated."""
    return calibrated_demo(num_grid, duration, freq_band=FREQ_RANGE, device=device)


def estimators(bf, bf_mat, demo) -> dict:
    """(B, T, M) frames → (B,) DoAs: the Hilbert beam power's argmax, and
    the matched profile of the folded Xylo rates."""
    grid = demo._doa_t
    return {
        "hilbert": lambda f: grid[(bf.apply_to_signal(bf_mat, f).abs() ** 2).mean(dim=1).argmax(dim=-1)],
        "xylo_matched": lambda f: demo.estimate_doa_from_rate(demo.fold(demo.rates_batch(f)), "matched"),
    }


def sweep(kind: str, values, est: dict, num_trials: int, seed: int = 0, duration: float = 0.25, noise=None,
          device=None) -> dict:
    rows = {"hilbert_mae_deg": [], "xylo_matched_mae_deg": []}
    for v in values:
        frames, doa_true = trial_frames(kind, v, num_trials, seed, duration, noise, device)
        truth = torch.as_tensor(doa_true, device=frames.device)
        for name, fn in est.items():
            err = folded_angle_error(fn(frames).to(torch.float64), truth)
            rows[name + "_mae_deg"].append(round(float(np.degrees(err.mean().item())), 2))
    return rows


def run(num_trials: int = 20, num_grid: int = 16 * 7, seed: int = 0, duration: float = 0.25, device=None,
        noise=None, model=None) -> dict:
    """Both sweeps; ``noise`` (num_trials, T, M) replaces the generator's
    and ``model`` :func:`build`'s triple."""
    bf, bf_mat, demo = model or build(num_grid, duration, device)
    est = estimators(bf, bf_mat, demo)
    return {
        "snr_db": SNR_DB, "num_trials": num_trials,
        "gain_spread_db": GAIN_DB, "gain": sweep("gain", GAIN_DB, est, num_trials, seed, duration, noise, demo.device),
        "pos_error_mm": POS_MM, "pos": sweep("pos", POS_MM, est, num_trials, seed, duration, noise, demo.device),
    }


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--trials", type=int, help="trials a value (default 20, 8 with --quick)")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 112, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    res = run(args.trials or (8 if args.quick else 20), args.grid or (17 if args.quick else 16 * 7),
              duration=args.duration or (0.05 if args.quick else 0.25), device=args.device)
    out = {"experiment": "mismatch_robustness", "results": res}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
