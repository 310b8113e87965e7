"""The push-to-hidden deployment, the port's twin of
``experiments/target_push_to_hidden.py`` (reference:
micloc/xylo_snn_localization_push_to_hidden.py).

The reference's main() runs only the board's power measurement (:678-708):
random input spikes at about 1 kHz for 2 ms pushed through
``_evolve_to_hidden`` at a 6.25 MHz core clock (:551-637).  Without the
board this reports the energy proxy of ``models.xylo.power`` over the same
workload, and a localization check through the on-chip path (encode →
stage-1 LIF → projection → stage-2 LIF → rate → peak):

    python -m haghighatshoarmuir2024_tpu_torch.experiments.target_push_to_hidden \
        [--quick] [--grid 112] [--duration 0.25] [--device cpu]

Prints one JSON object with the JAX twin's keys.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.xylo import DemoPushToHidden, estimate_power
from ..parallel import synthesize_batch
from .common import FS, sinusoid_template


def build_demo(num_grid: int = 16 * 7, duration: float = 0.25, device=None) -> DemoPushToHidden:
    return DemoPushToHidden(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1600, 1900]],
                            doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=duration,
                            kernel_duration=10e-3, bipolar_spikes=True, fs=FS, device=device)


def power_workload(demo, spk_rate: float = 1_000, duration: float = 2e-3, seed: int = 0):
    """The reference's random-spike workload (:597-611): (T, n_in) spikes
    at ``spk_rate`` Hz for ``duration`` s, from a seed, on the demo's
    device; and its full hidden raster (T, n_stage1 + n_stage2)."""
    T = int(FS * duration)
    rng = np.random.default_rng(seed)
    spikes_in = (rng.random((T, demo.xylo_config.n_in)) < spk_rate / FS).astype(np.int64)
    spikes_in = torch.as_tensor(spikes_in, device=demo.device)
    demo.xylo.reset_state()
    full, _, _ = demo.xylo.evolve_to_hidden(spikes_in)
    return spikes_in, full


def power_measurement(demo, duration: float = 2e-3) -> dict:
    spikes_in, full = power_workload(demo, duration=duration)
    est = estimate_power(demo.xylo_config, spikes_in, full[:, demo.xylo.n_stage1:], audio_duration=duration)
    return {k: float(v) for k, v in est.items()}


def localization_check(demo, num_trials: int = 8, snr_db: float = 10.0, seed: int = 0) -> dict:
    """The DoA error of ``num_trials`` noisy 1750 Hz frames through the
    on-chip path, all trials in one batch.  The draws are JAX's (numpy,
    ``seed``: a DoA, then the frame's noise, trial by trial)."""
    t, sig = sinusoid_template(1750.0, demo.recording_duration)
    t64 = torch.as_tensor(t, device=demo.device)
    s64 = torch.as_tensor(sig, device=demo.device)
    rng = np.random.default_rng(seed)
    doas, frames = [], []
    for _ in range(num_trials):
        doa = rng.uniform(-np.pi, np.pi)
        clean = synthesize_batch(demo.geometry, t64, s64, torch.as_tensor([doa], device=demo.device), FS)[0]
        clean = clean.cpu().numpy()
        noise = rng.standard_normal(clean.shape) * np.sqrt(np.mean(clean**2) / 10 ** (snr_db / 10))
        doas.append(doa)
        frames.append(clean + noise)
    hidden = demo.xylo_process(demo.spike_encoding(np.stack(frames)))  # (B, T, N)
    est = demo.estimate_doa_from_rate(demo.extract_rate(hidden, time_dim=1), "peak").cpu().numpy()
    errors = np.degrees(np.arcsin(np.abs(np.sin(est - np.asarray(doas)))))
    return {"snr_db": snr_db, "mae_deg": float(np.mean(errors)), "errors_deg": [float(e) for e in errors]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="4 localization trials instead of 8")
    ap.add_argument("--grid", type=int, default=16 * 7)
    ap.add_argument("--duration", type=float, default=0.25, help="frame length, s")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    demo = build_demo(num_grid=args.grid, duration=args.duration, device=args.device)
    cfg = demo.xylo_config
    out = {
        "experiment": "push_to_hidden",
        "power": power_measurement(demo),
        "localization": localization_check(demo, num_trials=4 if args.quick else 8),
        "w_rec_nonzeros": int(np.count_nonzero(np.asarray(cfg.w_rec))),
        "w_in_max_fan_out": int(np.count_nonzero(np.asarray(cfg.w_in), axis=1).max()),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
