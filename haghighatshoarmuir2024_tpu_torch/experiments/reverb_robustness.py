"""Localization under room reverberation, the port's twin of
``experiments/reverb_robustness.py`` (beyond the reference, whose simulation
is anechoic: one plane wave a source): the array input of each trial is the
direct path and its wall images to order 2 in a 5 x 4 m room
(``ops.interp.room_image_paths``, P = 13 paths, and
``signal_from_template_multipath``), a 1750 Hz tone at 10 dB SNR against
the direct path's power, the source at a random in-room position at least 1 m
from the array; the wall reflection coefficient sweeps 0, 0.3, 0.5, 0.7,
0.9.  Reported: the folded MAE against the direct path's DoA of the Hilbert
beamformer and of the quantized Xylo pipeline (matched estimator), 20
trials on a 112-point grid.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.reverb_robustness \\
        [--quick] [--trials N] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The positions come from
``numpy.random.default_rng(seed)`` as in JAX; the white noise (trials, T, M)
from a ``torch.Generator`` seeded with ``seed`` (JAX: ``split(PRNGKey(seed),
trials)``), the same for every coefficient, or from ``noise=``.  A
coefficient's trials are synthesized in one batch on the device and go
through one Hilbert scan (the batched ``Beamformer.apply_to_signal``) and one
``Demo.rates_batch`` (on the card: K1, K2, the pack and K3 once), then the
fold, the centring and the matched-profile product.  With
``HM2024_FIG_DIR`` set, ``main`` also writes JAX's figure there.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import resolve_device
from ..ops.interp import room_image_paths, signal_from_template_multipath
from ..parallel import folded_angle_error
from .common import FS, arg_parser, fig_lines
from .mismatch_robustness import build, estimators

ROOM = (5.0, 4.0)
ARRAY_XY = (2.2, 1.7)
REFLECTIONS = [0.0, 0.3, 0.5, 0.7, 0.9]
SNR_DB = 10.0


def sample_positions(rng, n: int, min_dist: float = 1.0) -> np.ndarray:
    """Random in-room source positions at least ``min_dist`` from the array
    centre (JAX's draws)."""
    out = []
    while len(out) < n:
        xy = rng.uniform([0.3, 0.3], [ROOM[0] - 0.3, ROOM[1] - 0.3])
        if np.hypot(xy[0] - ARRAY_XY[0], xy[1] - ARRAY_XY[1]) >= min_dist:
            out.append(xy)
    return np.asarray(out)


def path_tables(positions, reflection: float):
    """Each position's order-2 path table, stacked: (B, P) doas, extra
    delays, gains."""
    tabs = [room_image_paths(p, ARRAY_XY, ROOM, reflection=reflection, order=2) for p in positions]
    return tuple(np.stack([t[k] for t in tabs]) for k in range(3))


def trial_frames(geometry, t: torch.Tensor, sig: torch.Tensor, tables, noise: torch.Tensor) -> torch.Tensor:
    """(B, T, M) float32 reverberant frames: every path summed, plus
    ``noise`` at sigma ``sqrt(mean(direct²) / snr)`` of each trial's direct
    path alone (reflections are signal; the noise is the electronics')."""
    f32 = dict(dtype=torch.float32, device=t.device)
    doas, extra, gains = (torch.as_tensor(x, **f32) for x in tables)
    clean = signal_from_template_multipath(geometry, t, sig, doas, extra, gains, fs=FS)
    direct = signal_from_template_multipath(geometry, t, sig, doas[:, :1], extra[:, :1], gains[:, :1], fs=FS)
    sigma = torch.sqrt(torch.mean(direct**2, dim=(1, 2), keepdim=True) / 10 ** (SNR_DB / 10))
    return clean + sigma * noise


def run(num_trials: int = 20, num_grid: int = 16 * 7, seed: int = 0, duration: float = 0.25, device=None,
        noise=None, model=None) -> dict:
    """The sweep (module docstring); ``noise`` (num_trials, T, M) replaces
    the generator's draws and ``model`` ``mismatch_robustness.build``'s
    (bf, bf_mat, demo) triple: the same Hilbert design and Xylo model."""
    bf, bf_mat, demo = model or build(num_grid, duration, resolve_device(device))
    dev = demo.device
    est = estimators(bf, bf_mat, demo)
    f32 = dict(dtype=torch.float32, device=dev)
    t = np.arange(0, duration, 1 / FS)
    tt, ss = torch.as_tensor(t, **f32), torch.as_tensor(np.sin(2 * np.pi * 1750.0 * t), **f32)
    rng = np.random.default_rng(seed)
    positions = sample_positions(rng, num_trials)
    if noise is None:
        noise = torch.randn((num_trials, len(t), len(demo.geometry)), generator=torch.Generator(dev).manual_seed(seed),
                            **f32)
    noise = torch.as_tensor(noise, **f32)
    res = {"reflection": REFLECTIONS, "snr_db": SNR_DB, "num_trials": num_trials, "room": ROOM,
           "hilbert_mae_deg": [], "xylo_matched_mae_deg": []}
    for refl in REFLECTIONS:
        tables = path_tables(positions, refl)
        frames = trial_frames(demo.geometry, tt, ss, tables, noise)
        truth = torch.as_tensor(tables[0][:, 0], **f32)
        for name, fn in est.items():
            err = folded_angle_error(fn(frames).to(torch.float32), truth)
            res[name + "_mae_deg"].append(round(float(np.degrees(err.mean().item())), 2))
    return res


def figures(res: dict) -> None:
    """With ``HM2024_FIG_DIR`` set: each method's MAE against the wall
    reflection coefficient (JAX's figure)."""
    fig_lines(res["reflection"], {
        "Hilbert beamformer": res["hilbert_mae_deg"],
        "quantized Xylo (matched)": res["xylo_matched_mae_deg"],
    }, "reverb_robustness_mae.pdf", xlabel="wall reflection coefficient", ylabel="MAE [deg]")


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)  # --quick: 8 trials, 0.05 s frames, a 17-point grid
    ap.add_argument("--trials", type=int, default=None, help="trials a coefficient (default 20, 8 with --quick)")
    args = ap.parse_args(argv)
    res = run(args.trials or (8 if args.quick else 20), 17 if args.quick else 16 * 7,
              duration=0.05 if args.quick else 0.25, device=args.device)
    figures(res)
    out = {"experiment": "reverb_robustness", "results": res}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
