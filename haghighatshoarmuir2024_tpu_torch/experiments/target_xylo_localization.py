"""Monte-Carlo DoA accuracy of the quantized Xylo pipeline, the port's twin
of ``experiments/target_xylo_localization.py`` (tone only; reference:
paper_plots/target_xylo_localization.py, bipolar 100 trials, and
target_xylo_unipolar_localization.py, unipolar 20): a random DoA per trial,
the 11-point SNR sweep, two estimators on the same trials, and the spread
of the reference estimator over the simulator's four step conventions.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.target_xylo_localization \
        [--unipolar] [--quick] [--sims N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The trials run in
batches through ``Demo.forward_batch``'s path (encode → K1 → K2 → pack →
K3 on the card), the envelope through ``sim_hidden_batch``.
"""
from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.xylo import Demo
from ..models.xylo.sim import ORDERINGS, RESETS, sim_hidden_batch
from ..parallel import make_trial_fn, monte_carlo_sweep, synthesize_batch
from ..utils.peak_location import find_peak_location
from .common import FS, sinusoid_template, snr_sweep_config, summarize

VARIANTS = list(itertools.product(ORDERINGS, RESETS))
FREQ_RANGE = (1_000.0, 2_000.0)  # [0.5, 1] x the 2 kHz design frequency


def peak_window(num_grid: int) -> int:
    """The reference estimator's averaging window: grid // 32 made odd
    (paper_plots/target_xylo_localization.py:326-333)."""
    win = num_grid // 32
    return 2 * (win // 2) + 1


def reference_doa(demo, rate: torch.Tensor) -> torch.Tensor:
    """The reference estimator: the moving-average peak of each folded rate
    row (B, G), the plain argmax when the window is 1."""
    win = peak_window(len(demo.doa_list))
    idx = find_peak_location(rate, win) if win > 1 else torch.argmax(rate, dim=-1)
    return demo._doa_t[idx]


def build_demo(bipolar: bool = True, num_grid: int = 16 * 7, duration: float = 0.25, device=None) -> Demo:
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[list(FREQ_RANGE)],
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=duration,
                kernel_duration=10e-3, bipolar_spikes=bipolar, fs=FS, device=device)


def run(bipolar: bool = True, num_sims: int = 100, num_grid: int = 16 * 7, seed: int = 0, envelope: bool = True,
        duration: float = 0.25, device=None, batch_size=None, demo=None):
    """Both estimators' sweeps (``monte_carlo_sweep`` dicts) and, with
    ``envelope``, the convention envelope at min(num_sims, 25) trials."""
    demo = demo or build_demo(bipolar, num_grid, duration, device)
    t, sig = sinusoid_template(float(np.mean(FREQ_RANGE)), duration)

    def estimate(frames):
        return reference_doa(demo, demo.fold(demo.rates_batch(frames)))

    trial = make_trial_fn(demo.geometry, t, sig, estimate, FS, device=demo.device)
    out = {"reference_estimator": monte_carlo_sweep(trial, snr_sweep_config(), num_sims, seed, batch_size)}

    demo.calibrate_profiles(template=(t, sig))
    trial_m = make_trial_fn(demo.geometry, t, sig, lambda f: demo.forward_batch(f, method="matched")[0], FS,
                            device=demo.device)
    out["matched_estimator"] = monte_carlo_sweep(trial_m, snr_sweep_config(), num_sims, seed, batch_size)
    if envelope:
        out["reference_estimator_convention_envelope"] = convention_envelope(
            demo, t, sig, snr_sweep_config(), num_sims=min(num_sims, 25), seed=seed)
    return out


def convention_envelope(demo, t, sig, snr_db_vec, num_sims: int = 25, seed: int = 0, batch=None) -> dict:
    """Min-max MAE (degrees) of the reference-parity peak estimator over the
    four step conventions of the simulator (JAX ``convention_envelope``):
    every convention sees the same input rasters, so the spread is the
    convention's alone.  The draws are JAX's (numpy, ``seed``): DoAs in
    [-π, π), then per SNR float32 noise of the frames' shape.  All SNRs'
    frames go through ``batch`` rows at a time (all at once when None)."""
    G = len(demo.doa_list)
    grid = demo._doa_t
    rng = np.random.default_rng(seed)
    doa_true = rng.uniform(-np.pi, np.pi, size=num_sims)
    t64 = torch.as_tensor(np.asarray(t), dtype=torch.float64, device=demo.device)
    s64 = torch.as_tensor(np.asarray(sig), dtype=torch.float64, device=demo.device)
    clean = synthesize_batch(demo.geometry, t64, s64, torch.as_tensor(doa_true, device=demo.device), FS)
    clean = clean.to(torch.float32)
    sig_pow = torch.mean(clean**2, dim=(1, 2), keepdim=True)
    frames = []
    for snr_db in snr_db_vec:
        sigma = torch.sqrt(sig_pow / 10 ** (snr_db / 10))
        noise = rng.standard_normal(tuple(clean.shape)).astype(np.float32)
        frames.append(clean + sigma * torch.as_tensor(noise, device=demo.device))
    frames = torch.cat(frames)  # (S * num_sims, T, M)
    truth = torch.as_tensor(np.tile(doa_true, len(snr_db_vec)), device=demo.device)
    batch = batch or frames.shape[0]
    errs = {v: [] for v in VARIANTS}
    for s0 in range(0, frames.shape[0], batch):
        spikes_in = demo.spike_encoding(frames[s0:s0 + batch])
        for ordering, reset in VARIANTS:
            spk = sim_hidden_batch(demo.xylo_config, spikes_in, ordering=ordering, reset=reset, device=demo.device)
            rate = spk.to(torch.float32).mean(dim=1).reshape(spk.shape[0], -1, G).mean(dim=1)
            est = grid[torch.argmax(rate, dim=-1)]
            err = torch.abs(torch.arcsin(torch.abs(torch.sin(est - truth[s0:s0 + batch]))))
            errs[(ordering, reset)].append(torch.rad2deg(err).cpu().numpy())
    per_variant = {f"{o}/{r}": [float(m) for m in np.concatenate(errs[(o, r)]).reshape(len(snr_db_vec), -1)
                                .mean(axis=1)] for o, r in VARIANTS}
    S = len(snr_db_vec)
    return {
        "snr_db": [float(s) for s in snr_db_vec],
        "num_sims": num_sims,
        "mae_deg_by_variant": per_variant,
        "mae_deg_min": [float(min(v[i] for v in per_variant.values())) for i in range(S)],
        "mae_deg_max": [float(max(v[i] for v in per_variant.values())) for i in range(S)],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unipolar", action="store_true")
    ap.add_argument("--quick", action="store_true", help="10 trials a SNR")
    ap.add_argument("--sims", type=int, help="trials a SNR (default 100 bipolar, 20 unipolar)")
    ap.add_argument("--grid", type=int, default=16 * 7)
    ap.add_argument("--duration", type=float, default=0.25, help="template and frame length, s")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    bipolar = not args.unipolar
    sims = args.sims or (10 if args.quick else 100 if bipolar else 20)
    res = run(bipolar=bipolar, num_sims=sims, num_grid=args.grid, duration=args.duration, device=args.device)
    env = res.pop("reference_estimator_convention_envelope")
    sm = {k: summarize(v) for k, v in res.items()}
    sm["reference_estimator_convention_envelope"] = env
    out = {"experiment": f"target_xylo_{'bipolar' if bipolar else 'unipolar'}_localization", "results": sm}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
