"""The whole pipeline at a reduced internal rate, the port's twin of
``experiments/reduced_rate.py``: at 48, 24 and 12 kHz (``--band=hi``:
2300-2600 Hz at 48 and 24 kHz), 25 trials a SNR at 0 and 10 dB (8 with
``--quick``), a random DoA per trial, a 113-point grid; the folded MAE of
the matched and the peak estimator, and a flagship-style throughput section
(96 frames through ``forward_batch(matched)``, 30 calls back to back).

JAX's verdict, in its module docstring: 24 kHz is transparent, 12 kHz is
not.  At 12 kHz the array's largest inter-mic delay is 3.2 samples, and the
LIF time constant of the band, tau = 1/(2 pi f_mid), is 1.1 samples: the
quantized bitshift decay goes toward ``dash`` 0, a full decay each step.
12 kHz has no bundled design: ``Demo`` designs it on its device.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.reduced_rate \\
        [--band=hi] [--quick] [--grid G] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The DoAs and the noise come
from ``numpy.random.default_rng(seed)`` as in JAX, so both packages draw the
same trials; the 25 frames of a SNR go through one ``forward_batch`` (on the
card: K1, K2, the pack and K3 once).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..geometry import resolve_device
from ..models.xylo import Demo
from ..parallel import synthesize_batch
from .common import arg_parser, calibrated_demo, sync

SOUND_SPEED = 340.0


def tone_frames(demo: Demo, doas, freq_band) -> torch.Tensor:
    """(B, T, M) float32 frames of the band-centre tone from ``doas``, on the
    demo's device (JAX's vmapped ``signal_from_template`` in float32)."""
    f32 = dict(dtype=torch.float32, device=demo.device)
    t = np.arange(0, 0.25, 1 / demo.fs)
    sig = np.sin(2 * np.pi * float(np.mean(freq_band)) * t).astype(np.float32)
    return synthesize_batch(demo.geometry, torch.as_tensor(t, **f32), torch.as_tensor(sig, **f32),
                            torch.as_tensor(np.asarray(doas), **f32), demo.fs)


def trial_batch(demo: Demo, rng, num_sims: int, snr_db: float, freq_band):
    """One SNR's trials, in JAX's order of draws: the DoAs, then white noise
    at sigma ``sqrt(var(frame) / snr)`` per frame.  Returns the (B, T, M)
    float32 frames on the demo's device and the DoAs."""
    doas = rng.uniform(-np.pi, np.pi, size=num_sims)
    frames = tone_frames(demo, doas, freq_band).cpu().numpy()
    p_sig = frames.var(axis=(1, 2), keepdims=True)
    sigma = np.sqrt(p_sig / 10 ** (snr_db / 10))
    frames = frames + sigma * rng.standard_normal(frames.shape).astype(np.float32)
    return torch.as_tensor(frames, device=demo.device), doas


def run_rate(fs: int, num_sims: int, snr_db_vec, num_grid: int = 113, seed: int = 0, freq_band=(1600, 1900),
             device=None, demo=None, throughput: bool = True) -> dict:
    """One rate's row (JAX ``run_rate``); ``demo`` replaces the flagship
    model at ``fs`` on a ``num_grid``-point grid (``common.calibrated_demo``),
    and ``throughput=False`` skips the 96-frame timing."""
    dev = resolve_device(device) if demo is None else demo.device
    demo = demo or calibrated_demo(num_grid, fs=fs, freq_band=freq_band, device=dev)
    rng = np.random.default_rng(seed)
    err = lambda e, d: float(np.mean(np.degrees(np.arcsin(np.abs(np.sin(e - d))))))  # noqa: E731
    out = {"fs": fs, "snr_db": list(snr_db_vec)}
    mae_m, mae_p = [], []
    for snr_db in snr_db_vec:
        frames, doas = trial_batch(demo, rng, num_sims, snr_db, freq_band)
        d_est, rate = demo.forward_batch(frames, method="matched")
        mae_m.append(err(d_est.cpu().numpy().astype(np.float32), doas))  # float32, as JAX's forward returns them
        mae_p.append(err(demo.doa_list[rate.argmax(dim=-1).cpu().numpy()], doas))
    out["matched_mae_deg"] = mae_m
    out["peak_mae_deg"] = mae_p
    # the aperture arithmetic behind the numbers
    out["max_delay_samples"] = 2 * 4.5e-2 / SOUND_SPEED * fs
    out["tau_samples"] = fs / (2 * np.pi * float(np.mean(freq_band)))
    if throughput:
        B, reps = 96, 30
        frames = tone_frames(demo, np.linspace(-np.pi, np.pi, B, endpoint=False), freq_band)
        demo.forward_batch(frames, method="matched")
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            demo.forward_batch(frames, method="matched")
        sync(dev)
        dt = (time.perf_counter() - t0) / reps
        out["forward_ms_b96"] = dt * 1e3
        out["audio_sec_per_sec"] = B * 0.25 / dt
    return out


def run(band=(1600, 1900), num_sims: int = 25, num_grid: int = 113, device=None, throughput: bool = True,
        demos=None) -> dict:
    """Every rate of ``band`` (12 kHz for the default band only); ``demos``
    maps a rate to its model."""
    rates = (48_000, 24_000, 12_000) if tuple(band) == (1600, 1900) else (48_000, 24_000)
    demos = demos or {}
    rows = [run_rate(fs, num_sims, [0.0, 10.0], num_grid, freq_band=band, device=device, demo=demos.get(fs),
                     throughput=throughput) for fs in rates]
    return {"experiment": "reduced_rate_refutation", "band": list(band), "num_sims": num_sims, "rows": rows}


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--band", choices=("lo", "hi"), default="lo", help="hi: 2300-2600 Hz at 48 and 24 kHz")
    ap.add_argument("--grid", type=int, default=None, help="DoA grid points (default 113, 17 with --quick)")
    args = ap.parse_args(argv)
    band = (2300, 2600) if args.band == "hi" else (1600, 1900)
    res = run(band, 8 if args.quick else 25, args.grid or (17 if args.quick else 113), args.device,
              throughput=not args.quick)
    print(json.dumps(res, indent=2))
    print("\n# fs    max_delay(smp)  tau(smp)  MAE@0dB  MAE@10dB  b96-fwd(ms)  audio-s/s", file=sys.stderr)
    for r in res["rows"]:
        print(f"# {r['fs']:6d}  {r['max_delay_samples']:8.1f}  {r['tau_samples']:8.1f}  "
              f"{r['matched_mae_deg'][0]:7.2f}  {r['matched_mae_deg'][1]:8.2f}  "
              f"{r.get('forward_ms_b96', float('nan')):9.2f}  {r.get('audio_sec_per_sec', float('nan')):9.0f}",
              file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
