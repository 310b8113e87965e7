"""The accuracy cost of the serving wire codecs, the port's twin of
``experiments/wire_accuracy.py``: the same Monte-Carlo trials (a random DoA,
a 1750 Hz tone, white noise, the folded MAE) through each wire's round trip
(f32, PCM16 i16, mu-law u8, 4-bit mu-law u4, and u8/u4 at fs/4 rebuilt to 48
kHz) before the quantized pipeline with the matched estimator: 20 trials a
SNR at -10, 2 and 20 dB, a 113-point grid.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.wire_accuracy \\
        [--quick] [--trials N] [--grid G] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The round trip is the
client's ``runtime.server.WireEncoder``, then the host decode of
``ops.mulaw`` and ``ops.resample`` (numpy, bit-equal to JAX's); the DoAs and
the noise come from ``numpy.random.default_rng(seed)`` as in JAX.  A wire's
trials of a SNR go through one ``forward_batch`` (on the card: K1, K2, the
pack and K3 once).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import resolve_device
from ..models.xylo import Demo
from ..ops.interp import signal_from_template
from ..ops.mulaw import mulaw4_decode, mulaw_decode, unpack4
from ..ops.resample import design_upsample_fir, upsample_poly
from ..runtime.server import WireEncoder
from .common import FS, arg_parser, calibrated_demo, sinusoid_template

WIRES = [("f32", 1), ("i16", 1), ("u8", 1), ("u4", 1), ("u8", 4), ("u4", 4)]


def decode_wire(w: np.ndarray, wire: str) -> np.ndarray:
    """The daemon's decode of a wire array with time on axis 0, on the
    host: (T', ...) → (T, ...) audio."""
    if wire == "i16":
        return w.astype(np.float32) / 32768.0
    if wire == "u8":
        return mulaw_decode(w)
    if wire == "u4":
        return mulaw4_decode(unpack4(w))
    return w


def roundtrip(x: np.ndarray, wire: str, up: int) -> np.ndarray:
    """The host twin of the daemon's path: (T, M) → wire → (T, M) float32."""
    y = decode_wire(WireEncoder(wire, wire_upsample=up).encode(x), wire)
    if up > 1:
        y = upsample_poly(y, design_upsample_fir(up), up)
    return np.asarray(y, np.float32)


def trial_frames(demo: Demo, rng, num_sims: int, snr_db: float, duration: float = 0.25):
    """One SNR's frames on the host, in JAX's order of draws: per trial the
    DoA, then white noise at the clean frame's sigma; each frame scaled to a
    peak of 0.98.  Returns (B, T, M) float32 and the DoAs."""
    t, sig = sinusoid_template(1750.0, duration)
    f32 = dict(dtype=torch.float32, device=demo.device)
    tt, ss = torch.as_tensor(t, **f32), torch.as_tensor(sig, **f32)
    doas = rng.uniform(-np.pi, np.pi, num_sims)
    frames = []
    for d in doas:
        clean = signal_from_template(demo.geometry, tt, ss, float(d), fs=FS).cpu().numpy()
        sigma = np.sqrt((clean**2).mean() / 10 ** (snr_db / 10))
        x = clean + sigma * rng.standard_normal(clean.shape)
        frames.append((x / np.abs(x).max() * 0.98).astype(np.float32))
    return np.stack(frames), doas


def run(num_sims: int = 20, num_grid: int = 113, snrs=(-10.0, 2.0, 20.0), seed: int = 0, duration: float = 0.25,
        device=None, demo=None) -> dict:
    """MAE (deg) by wire and SNR; ``demo`` replaces the flagship model on a
    ``num_grid``-point grid (``common.calibrated_demo``)."""
    demo = demo or calibrated_demo(num_grid, duration, device=resolve_device(device))
    rng = np.random.default_rng(seed)
    out = {}
    for snr_db in snrs:
        frames, doas = trial_frames(demo, rng, num_sims, snr_db, duration)
        for wire, up in WIRES:
            fr = np.stack([roundtrip(f, wire, up) for f in frames])
            est, _ = demo.forward_batch(torch.as_tensor(fr, device=demo.device), method="matched")
            err = np.arcsin(np.abs(np.sin(est.cpu().numpy().astype(np.float64) - doas)))
            out.setdefault(wire + ("@12k" if up == 4 else ""), {})[snr_db] = round(float(np.rad2deg(err).mean()), 3)
    return out


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--trials", type=int, default=None, help="trials a SNR (default 20, 4 with --quick)")
    ap.add_argument("--grid", type=int, default=None, help="DoA grid points (default 113, 17 with --quick)")
    args = ap.parse_args(argv)
    out = run(args.trials or (4 if args.quick else 20), args.grid or (17 if args.quick else 113),
              duration=0.1 if args.quick else 0.25, device=args.device)
    res = {"experiment": "wire_accuracy", "mae_deg_by_wire_and_snr": out}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
