"""Moving-target tracking, the port's twin of ``experiments/moving_target.py``
(the working form of the reference's moving-target evaluations,
tests/test_snn_hilbert_localization.py:224-334): a 1500 Hz source sweeps a
120° arc over the recording at 10 dB; each frame's DoA from the Hilbert
beamformer and from the quantized Xylo pipeline (``Demo.forward``, the
peak estimator), raw and through the alpha-beta tracker ``track_angles``,
scored against the trajectory at the frame centres (median and mean
folded error).

    python -m haghighatshoarmuir2024_tpu_torch.experiments.moving_target \\
        [--quick] [--duration S] [--frame S] [--snr DB] [--grid G] [--device cpu]

Prints one JSON object with the JAX twin's keys.  JAX runs the Hilbert
frames one at a time, each from a zero filter state; here they go through
``apply_to_signal`` as one batch (B, T, M), the same arithmetic.  The Xylo
frames go one at a time through ``Demo.forward`` (on the card: K1, K2, the
raster pack and K5 once a frame).  The noise comes from a
``torch.Generator`` seeded with 0 (JAX: ``PRNGKey(0)``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.beamformer import Beamformer
from ..models.xylo import Demo
from ..ops.interp import received_signal
from ..utils import to_numpy
from ..utils.tracking import track_angles
from .common import FS, arg_parser, fig_lines, folded_deg, sinusoid_template

FREQ_DESIGN = 2_000.0
FREQ_RANGE = (0.5 * FREQ_DESIGN, FREQ_DESIGN)
HILBERT_CHUNK = 8  # frames an apply call: its (8, T, 224) complex64 output is 0.17 GB at 0.25 s


def build_demo(num_grid: int = 32 * 7, frame: float = 0.25, device=None) -> Demo:
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[list(FREQ_RANGE)],
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=frame, kernel_duration=10e-3,
                bipolar_spikes=True, fs=FS, device=device)


def scene(duration: float = 4.0, snr_db: float = 10.0, frame: float = 0.25, device=None, seed: int = 0):
    """The source's trajectory (t, doa_traj), its array signal (T, M)
    float64 on ``device`` with the noise from a generator seeded with
    ``seed``, and the true DoA at each frame centre."""
    from ..geometry import resolve_device

    dev = resolve_device(device)
    t = np.arange(0, duration, 1 / FS)
    doa_traj = -np.pi / 3 + (2 * np.pi / 3) * (t / t[-1])
    f64 = dict(dtype=torch.float64, device=dev)
    sig_in = received_signal(CenterCircularArray(radius=4.5e-2, num_mic=7), torch.as_tensor(t, **f64),
                             torch.as_tensor(np.sin(2 * np.pi * 0.75 * FREQ_DESIGN * t), **f64),
                             torch.as_tensor(doa_traj, **f64), snr_db=snr_db,
                             generator=torch.Generator(dev).manual_seed(seed), fs=FS)
    n_frames = int(duration / frame)
    return sig_in, np.interp((np.arange(n_frames) + 0.5) * frame, t, doa_traj)


def split_frames(sig_in: torch.Tensor, n_frames: int, frame: float) -> torch.Tensor:
    """The array signal (T, M) → its first ``n_frames`` frames (n_frames,
    frame·FS, M) float32."""
    Tf = int(frame * FS)
    return sig_in[:n_frames * Tf].reshape(n_frames, Tf, -1).to(torch.float32)


def scores(est, doa_true) -> dict:
    err = folded_deg(est, doa_true)
    return {"median_err_deg": float(np.median(err)), "mae_deg": float(err.mean())}


def run(duration: float = 4.0, snr_db: float = 10.0, frame: float = 0.25, num_grid: int = 32 * 7, device=None,
        sig_in=None, demo=None) -> dict:
    """The four rows; ``sig_in`` (T, M) replaces the generated array signal
    and ``demo`` the Xylo model built for the grid and frame.  With
    ``HM2024_FIG_DIR`` set, the tracks also go to ``moving_target_track.pdf``."""
    generated, doa_true = scene(duration, snr_db, frame, device)
    dev = generated.device
    sig_in = generated if sig_in is None else torch.as_tensor(sig_in, device=dev)
    frames = split_frames(sig_in, len(doa_true), frame)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    results = {}

    bf = Beamformer(CenterCircularArray(radius=4.5e-2, num_mic=7), 10e-3, FREQ_RANGE, fs=FS, device=dev)
    bf_mat, _ = bf.design_from_template(sinusoid_template(0.75 * FREQ_DESIGN, frame), doa_list)
    idx = torch.cat([(bf.apply_to_signal(bf_mat, frames[i:i + HILBERT_CHUNK]).abs() ** 2).mean(dim=1).argmax(dim=-1)
                     for i in range(0, frames.shape[0], HILBERT_CHUNK)])
    ests = doa_list[to_numpy(idx)]
    results["hilbert"] = scores(ests, doa_true)
    # the wrapped-angle alpha-beta tracker on the per-frame estimates (beyond
    # the reference, which scores raw frames)
    tracked = to_numpy(track_angles(ests.astype(np.float32), device=dev))
    results["hilbert_tracked"] = scores(tracked, doa_true)

    demo = demo or build_demo(num_grid, frame, dev)
    ests_x = np.array([float(demo.forward(f)[0]) for f in frames])
    results["xylo"] = scores(ests_x, doa_true)
    tracked_x = to_numpy(track_angles(ests_x.astype(np.float32), device=dev))
    results["xylo_tracked"] = scores(tracked_x, doa_true)
    fig_lines((np.arange(len(doa_true)) + 0.5) * frame, {
        "true": np.rad2deg(doa_true),
        "hilbert": np.rad2deg(ests),
        "xylo": np.rad2deg(ests_x),
        "hilbert tracked": np.rad2deg(tracked),
        "xylo tracked": np.rad2deg(tracked_x),
    }, "moving_target_track.pdf", xlabel="time [s]", ylabel="DoA [deg]")
    return results


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--duration", type=float, help="recording, s (default 4, 0.4 with --quick)")
    ap.add_argument("--frame", type=float, help="frame, s (default 0.25, 0.05 with --quick)")
    ap.add_argument("--snr", type=float, default=10.0)
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 17 with --quick)")
    args = ap.parse_args(argv)
    results = run(args.duration or (0.4 if args.quick else 4.0), args.snr,
                  args.frame or (0.05 if args.quick else 0.25), args.grid or (17 if args.quick else 32 * 7),
                  args.device)
    res = {"experiment": "moving_target", "results": results}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
