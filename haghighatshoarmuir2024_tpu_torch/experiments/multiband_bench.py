"""The three-band model's throughput and accuracy, the port's twin of
``experiments/multiband_bench.py``: the flagship program at F = 3 (bands
1600-2000, 2000-2300, 2300-2600 Hz; C = 42 encode channels, N = 1347 hidden
neurons, past the Xylo-A2 chip's 1000: ``enforce_hw_limits=False``) on 96
frames of the wideband template (``models/xylo/multiband.py``), gated as
bench.py gates the flagship: doa-ok-frac @5 deg (matched), the reference
peak estimator's @25 deg beside it.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.multiband_bench \\
        [--fs=24000] [--quick] [--device cpu]

Prints one JSON object with the JAX twin's keys.  ``compile_s`` is the first
batch's extra time over a warm one (CUDA and library set-up on the card).
The noise comes from ``numpy.random.default_rng(0)`` (JAX: ``PRNGKey(0)``);
``run(frames=...)`` takes other frames, JAX's draws say.
"""
from __future__ import annotations

import json
import time

import numpy as np

from ..geometry import resolve_device
from ..models.xylo import Demo
from ..models.xylo.multiband import multiband_config, multiband_frames, wideband_template
from .common import arg_parser, sync


def run(fs: int = 48_000, batch: int = 96, n_rep: int = 100, device=None, demo=None, frames=None,
        config_overrides=None) -> dict:
    """Design (unless ``demo`` is given: then already calibrated folded, and
    ``design_s``/``calib_s`` are None), calibrate on the wideband template,
    and time ``forward_batch(matched)`` over ``n_rep`` calls on ``frames``
    (``(B, T, M)``, doas), ``multiband_frames(demo, batch, seed=0)`` when
    None.  ``config_overrides`` changes ``multiband_config``'s keywords (a
    smaller grid for a test)."""
    dev = resolve_device(device) if demo is None else demo.device
    design_s = calib_s = None
    t0 = time.perf_counter()
    if demo is None:
        demo = Demo(**{**multiband_config(dev, fs), **(config_overrides or {})})
        sync(dev)
        design_s = time.perf_counter() - t0
    x, doas = frames if frames is not None else multiband_frames(demo, batch, seed=0)[:2]
    if demo._profiles is None:
        t0c = time.perf_counter()
        demo.calibrate_profiles(template=wideband_template(demo.fs))
        sync(dev)
        calib_s = time.perf_counter() - t0c

    t0 = time.perf_counter()
    doa, _ = demo.forward_batch(x, method="matched")
    doa_peak, _ = demo.forward_batch(x, method="peak")
    sync(dev)
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for _ in range(n_rep):
        doa, _ = demo.forward_batch(x, method="matched")
    sync(dev)
    elapsed = (time.perf_counter() - t1) / n_rep
    B = x.shape[0]

    def ok_frac(est, tol_deg):
        err = np.abs(np.arcsin(np.abs(np.sin(est.cpu().numpy().astype(np.float64) - doas))))
        return float(np.mean(np.rad2deg(err) < tol_deg))

    return {
        "experiment": "multiband_flagship_bench",
        "fs": demo.fs,
        "freq_bands": demo.freq_bands.tolist(),
        "batch": B,
        "throughput_audio_sec_per_sec": round(B * demo.recording_duration / elapsed, 2),
        "ms_per_batch": round(elapsed * 1000, 2),
        "design_s": None if design_s is None else round(design_s, 1),
        "calib_s": None if calib_s is None else round(calib_s, 1),
        "compile_s": round(max(first_s - 2 * elapsed, 0.0), 1),
        "doa_ok_frac_matched_5deg": ok_frac(doa, 5.0),
        "doa_ok_frac_peak_25deg": ok_frac(doa_peak, 25.0),
    }


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--fs", type=int, default=48_000, help="the internal rate (24000: the reduced-rate mode)")
    args = ap.parse_args(argv)
    quick = dict(doa_list=np.linspace(-np.pi, np.pi, 17)) if args.quick else None
    res = run(args.fs, 4 if args.quick else 96, 2 if args.quick else 100, args.device, config_overrides=quick)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
