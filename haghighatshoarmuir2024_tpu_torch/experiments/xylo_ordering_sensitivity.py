"""The simulator's step convention measured, the port's twin of
``experiments/xylo_ordering_sensitivity.py``.

rockpool's ``XyloSim`` cannot run here, so the integer LIF's exact step
convention (micloc/xylo_snn_localization.py:286-313 delegates it) cannot be
replayed.  This harness runs the quantized localization Monte-Carlo under
every plausible convention, {decay_first, integrate_first} x {subtract,
zero}, on the same input rasters, and reports each one's MAE and its
difference from the default, on a 1750 Hz tone or, with ``--speech``, on
``common.speech_template(duration)``:

    python -m haghighatshoarmuir2024_tpu_torch.experiments.xylo_ordering_sensitivity \
        [--sims 20] [--grid 225] [--snrs -10 0 10] [--speech] [--duration 0.25] [--quick] [--json] [--device cpu]

A table goes to stdout, per-variant lines with their seconds to stderr,
and with ``--json`` one JSON line with the JAX twin's keys.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.xylo import Demo
from ..models.xylo.sim import sim_hidden_batch
from ..parallel import synthesize_batch
from .common import FS, speech_template
from .target_xylo_localization import VARIANTS


def angular_err_deg(est: np.ndarray, true: np.ndarray) -> np.ndarray:
    return np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(np.asarray(est) - np.asarray(true))))))


def build_demo(grid: int = 225, duration: float = 0.25, device=None) -> Demo:
    """The harness's bipolar model: one band [1600, 1900] Hz on a
    ``grid``-point grid, designed with a ``duration`` s tone."""
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1600, 1900]],
                doa_list=np.linspace(-np.pi, np.pi, grid), recording_duration=duration, kernel_duration=10e-3,
                bipolar_spikes=True, fs=FS, device=device)


def trial_frames(demo, sims: int, snrs, speech: bool, duration: float):
    """JAX's draws (numpy, ``default_rng(0)``): ``sims`` DoAs in [-π, π),
    the clean frames of the 1750 Hz tone or the speech synthesized on the
    demo's device, then per SNR of ``snrs`` float32 noise scaled to each
    frame.  Returns the DoAs and one (sims, T, M) float32 array a SNR."""
    dev = demo.device
    t = torch.arange(0, duration, 1 / FS, dtype=torch.float64, device=dev)
    if speech:
        template = torch.as_tensor(np.asarray(speech_template(duration=duration)[1], np.float32), device=dev)
    else:
        template = torch.sin(2 * np.pi * 1750 * t).to(torch.float32)
    template = template.to(torch.float64)  # the float32 template's values, as JAX's harness takes them
    rng = np.random.default_rng(0)
    doa_true = rng.uniform(-np.pi, np.pi, size=sims).astype(np.float64)
    clean = synthesize_batch(demo.geometry, t, template, torch.as_tensor(doa_true, device=dev), FS).cpu().numpy()
    frames = []
    for snr_db in snrs:
        noisy = []
        for s in clean:
            p_sig = np.mean(s**2)
            noise = rng.standard_normal(s.shape).astype(np.float32)
            noise *= np.sqrt(p_sig / np.mean(noise**2) * 10 ** (-snr_db / 10))
            noisy.append(s + noise)
        frames.append(np.stack(noisy).astype(np.float32))
    return doa_true, frames


def simulate(demo, spikes_in, ordering: str, reset: str):
    """The input raster (B, T, C') through the simulator under one step
    convention: the hidden raster (B, T, F·G) and the DoAs (B,) of the
    peak of the band-averaged rates."""
    G = len(demo.doa_list)
    spk = sim_hidden_batch(demo.xylo_config, spikes_in, ordering=ordering, reset=reset, device=demo.device)
    rate = spk.to(torch.float32).mean(dim=1)
    rate = rate.reshape(rate.shape[0], -1, G).mean(dim=1)
    return spk, demo.doa_list[torch.argmax(rate, dim=-1).cpu().numpy()]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sims", type=int, default=20, help="MC trials per SNR")
    ap.add_argument("--grid", type=int, default=225)
    ap.add_argument("--snrs", type=float, nargs="+", default=[-10.0, 0.0, 10.0])
    ap.add_argument("--speech", action="store_true", help="speech target instead of tone")
    ap.add_argument("--duration", type=float, default=0.25)
    ap.add_argument("--quick", action="store_true", help="4 trials per SNR")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    sims = 4 if args.quick else args.sims
    G = args.grid
    demo = build_demo(G, args.duration, args.device)
    doa_true, frames_by_snr = trial_frames(demo, sims, args.snrs, args.speech, args.duration)

    results = {f"{o}/{r}": {} for o, r in VARIANTS}
    raster_delta = {}
    for snr_db, frames in zip(args.snrs, frames_by_snr):
        spikes_in = demo.spike_encoding(frames)  # (B, T, N_in)
        base = None
        for ordering, reset in VARIANTS:
            name = f"{ordering}/{reset}"
            t0 = time.time()
            spk, est = simulate(demo, spikes_in, ordering, reset)
            err = angular_err_deg(est, doa_true)
            results[name][snr_db] = (float(np.mean(err)), float(np.median(err)))
            if base is None:
                base = spk
            else:
                raster_delta[(name, snr_db)] = float((spk != base).to(torch.float64).mean())
            print(f"# snr {snr_db:+.0f} dB  {name:<26s} MAE {results[name][snr_db][0]:6.2f} deg  "
                  f"median {results[name][snr_db][1]:6.2f} deg  ({time.time() - t0:.1f}s)", file=sys.stderr)

    target = "speech" if args.speech else "tone"
    print(f"\n== XyloSim step-ordering sensitivity ({target}, {sims} trials/SNR, grid {G}) ==")
    print("variant".ljust(28) + "".join(f"  MAE@{s:+.0f}dB" for s in args.snrs))
    for name, per_snr in results.items():
        print(name.ljust(28) + "".join(f"  {per_snr[s][0]:8.2f}" for s in args.snrs))
    print("\ndelta vs default (decay_first/subtract):")
    base_mae = results["decay_first/subtract"]
    worst = 0.0
    for name, per_snr in results.items():
        if name == "decay_first/subtract":
            continue
        deltas = [per_snr[s][0] - base_mae[s][0] for s in args.snrs]
        worst = max(worst, max(abs(d) for d in deltas))
        print(name.ljust(28) + "".join(f"  {d:+8.2f}" for d in deltas)
              + f"   raster diff {np.mean([raster_delta[(name, s)] for s in args.snrs]):.4f}")
    print(f"\nordering ambiguity costs <= {worst:.2f} deg MAE on this MC")
    out = {"target": target, "sims": sims, "grid": G, "snrs": args.snrs,
           "mae_by_variant": {k: {str(s): v[s] for s in args.snrs} for k, v in results.items()},
           "worst_delta_deg": worst}
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
