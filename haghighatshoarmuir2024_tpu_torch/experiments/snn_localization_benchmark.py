"""The live-style benchmark of the quantized SNN, the port's twin of
``experiments/snn_localization_benchmark.py`` (itself the twin of
paper_plots/snn_localization_benchmark.py, the paper's demo benchmark): N
DoA estimates from repeated noisy frames of one source, saved to a
timestamped ``.txt`` under ``$HM2024_BENCH_DIR`` and analysed as the
reference analyses its board's runs (``utils.stats.analyze_doa_samples``:
a windowed median with jump rejection, :595-660).

The configuration is the reference benchmark's (:549-583): 0.4 s frames
(T = 19 200 steps), a 20 ms STHT kernel (960 taps), a 449-point grid,
bipolar spikes, the peak estimator of JAX's ``_forward_jit``; a 1600-2000
Hz chirp from 2.2439 rad at 10 dB.  Each frame is the clean frame plus
fresh white noise, optionally with the nonstationarity of live recordings:
a per-frame per-mic gain drift (``gain_std_db``, log-normal) and source
sway (``sway_deg``, Gaussian DoA jitter, frames re-synthesized per DoA;
``sway_corr`` makes it an AR(1) drift).  ``reflection`` > 0 synthesizes the
clean frame in a 5 x 4 m room by the image-source model to order 2
(``ops.interp.room_image_paths``, ``signal_from_template_multipath``).
Frames go through ``Demo.forward_batch(method="peak")`` ``batch`` at a
time (on the card: K1, K2, the pack and K3 once a batch).

    python -m haghighatshoarmuir2024_tpu_torch.experiments.snn_localization_benchmark \\
        [--sweep] [--quick] [--samples N] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The sway draws come from
``numpy.random.default_rng(1)`` as in JAX; the white noise and the gains
from a ``torch.Generator`` seeded with 0 (JAX: ``PRNGKey(0)`` split a
batch), or from ``noise=``/``gain_noise=``.  The reference's own recorded
runs are re-analysed when its checkout is present.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..geometry import CenterCircularArray, resolve_device
from ..models.xylo import Demo
from ..ops.interp import room_image_paths, signal_from_template, signal_from_template_multipath
from ..parallel import synthesize_batch
from ..utils.stats import analyze_doa_samples
from .common import FS, SPEECH_FLAC, arg_parser, chirp_template

REF_ROOT = os.path.dirname(SPEECH_FLAC)  # the reference checkout's paper_plots directory
REF_DATA_DIRS = [os.path.join(REF_ROOT, f"demo-benchmark-simulation-freq{band}")
                 for band in ("1600-2000", "2000-2300", "2300-2600")]
ROOM, ARRAY_XY = (5.0, 4.0), (2.2, 1.7)  # reverb_robustness.py's room
# the sweep's conditions (JAX :190-197): sway and AR(1) drift at 10 dB, free field
CONDITIONS = [
    dict(snr_db=10.0, reflection=0.0, sway_deg=2.0),
    dict(snr_db=10.0, reflection=0.0, sway_deg=3.0),
    dict(snr_db=10.0, reflection=0.0, sway_deg=4.0),
    dict(snr_db=10.0, reflection=0.0, sway_deg=5.0),
    dict(snr_db=10.0, reflection=0.0, sway_deg=3.0, sway_corr=0.96),
    dict(snr_db=10.0, reflection=0.0, sway_deg=5.0, sway_corr=0.96),
]


def make_demo(freq_band=(1600, 2000), num_grid: int = 64 * 7 + 1, frame: float = 0.4, device=None) -> Demo:
    """The reference benchmark's model (``frame`` and ``num_grid`` smaller
    for a test)."""
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[list(freq_band)],
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=frame, kernel_duration=20e-3,
                bipolar_spikes=True, fs=FS, device=device)


def _chirp(demo: Demo, freq_band):
    f32 = dict(dtype=torch.float32, device=demo.device)
    t, sig = chirp_template(freq_band, demo.recording_duration)
    return torch.as_tensor(t, **f32), torch.as_tensor(sig, **f32)


def clean_frame(demo: Demo, freq_band, doa_true: float, reflection: float = 0.0) -> torch.Tensor:
    """The (T, M) float32 array input of the benchmark chirp on the demo's
    device: free field, or with ``reflection`` > 0 the direct path and its
    wall images to order 2, the source 1.5 m from the array."""
    t, sig = _chirp(demo, freq_band)
    if reflection <= 0.0:
        return signal_from_template(demo.geometry, t, sig, doa_true, fs=FS)
    src = (ARRAY_XY[0] + 1.5 * np.cos(doa_true), ARRAY_XY[1] + 1.5 * np.sin(doa_true))
    doas, extra, gains = room_image_paths(src, ARRAY_XY, ROOM, reflection=reflection, order=2)
    return signal_from_template_multipath(demo.geometry, t, sig, doas, extra, gains, fs=FS)


def sway_doas(doa_true: float, num_samples: int, sway_deg: float, sway_corr: float = 0.0) -> np.ndarray:
    """Each frame's DoA under sway: iid Gaussian jitter, or with
    ``sway_corr`` > 0 an AR(1) drift of the same stationary std, from
    ``numpy.random.default_rng(1)`` (JAX's draws)."""
    innov = np.random.default_rng(1).standard_normal(num_samples)
    if sway_corr > 0.0:
        x = np.empty(num_samples)
        x[0] = innov[0]
        scale = np.sqrt(1.0 - sway_corr**2)
        for k in range(1, num_samples):
            x[k] = sway_corr * x[k - 1] + scale * innov[k]
        innov = x
    return doa_true + np.deg2rad(sway_deg) * innov


def collect(num_samples: int = 200, freq_band=(1600, 2000), doa_true: float = 2.2439, snr_db: float = 10.0,
            reflection: float = 0.0, demo=None, batch: int = 20, gain_std_db: float = 0.0, sway_deg: float = 0.0,
            sway_corr: float = 0.0, device=None, noise=None, gain_noise=None):
    """``num_samples`` DoA estimates (degrees) and the seconds they took
    (module docstring).  ``noise`` (n_batches, batch, T, M) and
    ``gain_noise`` (n_batches, batch, 1, M), standard normal, replace the
    generator's draws; a batch's white noise and gains are its rows."""
    if sway_deg > 0.0 and reflection > 0.0:
        # sway re-synthesizes free-field frames: combined with a room it would
        # report free-field results under a reverberant heading
        raise ValueError("sway_deg and reflection cannot be combined: the sway path re-synthesizes free-field frames")
    dev = resolve_device(device) if demo is None else demo.device
    demo = demo or make_demo(freq_band, device=dev)
    sig_clean = clean_frame(demo, freq_band, doa_true, reflection)
    sigma = float(np.sqrt(np.mean(sig_clean.cpu().numpy() ** 2) / 10 ** (snr_db / 10)))
    doas = None
    if sway_deg > 0.0:
        doas = sway_doas(doa_true, num_samples, sway_deg, sway_corr)
        doas = np.concatenate([doas, np.repeat(doas[-1:], (-num_samples) % batch)])  # the tail batch padded
        t, sig = _chirp(demo, freq_band)
    gen = torch.Generator(dev).manual_seed(0)
    f32 = dict(dtype=torch.float32, device=dev)
    samples = []
    t0 = time.perf_counter()
    for k, s0 in enumerate(range(0, num_samples, batch)):
        n = min(batch, num_samples - s0)
        if doas is None:
            x = sig_clean.to(torch.float32).expand(batch, *sig_clean.shape)
        else:
            x = synthesize_batch(demo.geometry, t, sig, torch.as_tensor(doas[s0:s0 + batch], **f32), FS)
        white = (torch.randn(x.shape, generator=gen, **f32) if noise is None
                 else torch.as_tensor(np.asarray(noise[k]), **f32))
        if gain_std_db > 0.0:
            g = (torch.randn((batch, 1, x.shape[-1]), generator=gen, **f32) if gain_noise is None
                 else torch.as_tensor(np.asarray(gain_noise[k]), **f32))
            x = x * 10.0 ** (gain_std_db * g / 20.0)
        doa, _ = demo.forward_batch(x + sigma * white, method="peak")
        samples.extend(np.rad2deg(doa.cpu().numpy().astype(np.float32))[:n].tolist())
    return np.asarray(samples), time.perf_counter() - t0


def sweep(num_samples: int = 200, demo=None, device=None, noise=None, batch: int = 20) -> dict:
    """The dispersion sweep (JAX ``sweep``): :data:`CONDITIONS`, each through
    :func:`collect` on one model and analysed; ``noise`` is each condition's."""
    demo = demo or make_demo((1600, 2000), device=resolve_device(device))
    rows = []
    for cond in CONDITIONS:
        samples, _ = collect(num_samples=num_samples, demo=demo, batch=batch, noise=noise, **cond)
        stats = analyze_doa_samples(samples, window_length=min(25, num_samples // 2), reject_jump=20.0)
        rows.append({**cond, "mae_deg": round(stats["doa_mae_postprocessed"], 4),
                     "robust_std_deg": round(stats["robust_std"], 4), "raw_std_deg": round(stats["std"], 4)})
        print(f"# snr {cond['snr_db']:+5.1f} dB  reflection {cond.get('reflection', 0.0):.1f}  gain "
              f"{cond.get('gain_std_db', 0.0):.1f} dB  sway {cond.get('sway_deg', 0.0):.1f} deg  corr "
              f"{cond.get('sway_corr', 0.0):.2f}  ->  MAE {rows[-1]['mae_deg']:7.4f} deg  robust-std "
              f"{rows[-1]['robust_std_deg']:7.4f} deg  raw-std {rows[-1]['raw_std_deg']:7.4f} deg",
              file=sys.stderr, flush=True)
    return {"experiment": "snn_localization_benchmark_sweep", "num_samples": num_samples, "conditions": rows,
            "reference_band": {"mae_deg": [0.43, 0.66], "robust_std_deg": [1.0, 3.0]}}


def bench_dir() -> str:
    """Where runs are saved: ``$HM2024_BENCH_DIR``, else a directory in the
    temporary directory."""
    return os.environ.get("HM2024_BENCH_DIR", os.path.join(tempfile.gettempdir(), "hm2024-benchmark"))


def run(num_samples: int = 200, demo=None, device=None, noise=None) -> dict:
    """One collected run, saved and analysed, and the reference's recorded
    runs re-analysed where present (JAX ``main``)."""
    samples, wall = collect(num_samples=num_samples, demo=demo, device=device, noise=noise)
    outdir = bench_dir()
    os.makedirs(outdir, exist_ok=True)
    fname = os.path.join(outdir, time.strftime("%Y-%m-%d=>%H:%M:%S") + ".txt")
    np.savetxt(fname, samples, fmt="%0.6f")
    stats = analyze_doa_samples(samples, window_length=min(25, num_samples // 2), reject_jump=20.0)
    frame = demo.recording_duration if demo is not None else 0.4
    report = {"experiment": "snn_localization_benchmark",
              "collected": {"file": fname, "num_samples": int(num_samples),
                            "audio_sec_per_sec": num_samples * frame / wall,
                            **{k: round(v, 4) for k, v in stats.items()}}}
    ref = {}
    for d in REF_DATA_DIRS:
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                s = analyze_doa_samples(np.loadtxt(os.path.join(d, f)))
                ref[os.path.basename(d) + "/" + f] = round(s["doa_mae_postprocessed"], 4)
    if ref:
        report["reference_committed_mae"] = ref
    return report


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--sweep", action="store_true", help="the six sway and drift conditions")
    ap.add_argument("--samples", type=int, default=None, help="samples a run (default 200, 25 with --quick)")
    args = ap.parse_args(argv)
    n = args.samples or (25 if args.quick else 200)
    dev = resolve_device(args.device)
    demo = make_demo(num_grid=17, frame=0.1, device=dev) if args.quick else make_demo(device=dev)
    res = sweep(n, demo) if args.sweep else run(n, demo)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
