"""Two moving sources whose bearings cross, tracked through MUSIC: the
port's twin of ``experiments/multi_target_tracking.py`` (beyond the
reference, whose multi-target study is static,
paper_plots/multiple_targets_*.py:87-246).  Two tones (0.75 and 0.80 of
2 kHz) sweep -80° → +40° and +80° → -40°, synthesized with the reference's
MUSIC convention (``t − delay``) at 10 dB; per frame the noise-subspace
pseudospectrum (``num_sources=2``), its two best peaks (``top_k_peaks``) and
the gated tracker ``track_multi_angles``, against the memoryless baseline
that sorts each frame's peaks by bearing.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.multi_target_tracking \\
        [--snr DB] [--quick] [--duration S] [--frame S] [--grid G] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The frames go through
``MUSIC.beamforming`` as one batch (B, T, M); the noise comes from
``numpy.random.default_rng(0)``, as in JAX.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.music import MUSIC
from ..ops.interp import signal_from_template
from ..ops.peaks import top_k_peaks
from ..utils import to_numpy
from ..utils.tracking import track_multi_angles
from .common import FS, arg_parser, fig_lines, folded_deg

FREQ_DESIGN = 2_000.0
FREQ_RANGE = (0.5 * FREQ_DESIGN, FREQ_DESIGN)
PROBE = 3  # the frame where each truth is matched to its confirmed slot, before the crossing


def scene(duration: float = 6.0, snr_db: float = 10.0, seed: int = 0):
    """The two trajectories (float32, as JAX makes them) and the noisy
    (T, M) float64 mixture, on the host."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, duration, 1 / FS)
    traj1 = np.deg2rad(-80 + 120 * t / t[-1]).astype(np.float32)
    traj2 = np.deg2rad(80 - 120 * t / t[-1]).astype(np.float32)
    tt = torch.as_tensor(t)
    x = sum(signal_from_template(geometry, tt, torch.sin(2 * np.pi * f * FREQ_DESIGN * tt), torch.as_tensor(tr),
                                 fs=FS, delay_sign=-1).numpy()
            for f, tr in ((0.75, traj1), (0.80, traj2)))
    rng = np.random.default_rng(seed)
    return t, traj1, traj2, x + np.sqrt(np.mean(x**2) / 10 ** (snr_db / 10)) * rng.standard_normal(x.shape)


def run(duration: float = 6.0, snr_db: float = 10.0, frame: float = 0.25, num_grid: int = 32 * 7, device=None,
        sig_in=None) -> dict:
    """The tracked and baseline errors; ``sig_in`` (T, M) replaces the
    mixture.  With ``HM2024_FIG_DIR`` set, the tracks also go to
    ``multi_target_tracking.pdf``."""
    t, traj1, traj2, mix = scene(duration, snr_db)
    sig_in = mix if sig_in is None else sig_in
    n_frames, Tf = int(duration / frame), int(frame * FS)
    centers = (np.arange(n_frames) + 0.5) * frame
    true1, true2 = np.interp(centers, t, traj1), np.interp(centers, t, traj2)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    music = MUSIC(CenterCircularArray(radius=4.5e-2, num_mic=7), FREQ_RANGE, doa_list, frame_duration=frame, fs=FS,
                  device=device)
    frames = torch.as_tensor(np.asarray(sig_in)[:n_frames * Tf].reshape(n_frames, Tf, -1), device=music.device)
    idx, _, ok = top_k_peaks(music.beamforming(frames, 2, 2048, num_sources=2), 2, distance=num_grid // 32,
                             rel_height=0.2)
    z = doa_list[to_numpy(idx)].astype(np.float32)
    valid = to_numpy(ok)
    # the memoryless baseline: identity by sorted bearing, which swaps at the crossing by construction
    z_sorted = np.sort(np.where(valid, z, np.nan), axis=1)
    base1, base2 = folded_deg(z_sorted[:, 0], true1), folded_deg(z_sorted[:, 1], true2)

    thetas, confirmed = track_multi_angles(z, valid, num_tracks=4, max_misses=4, device=music.device)
    thetas, confirmed = to_numpy(thetas), to_numpy(confirmed)
    slots = np.nonzero(confirmed[PROBE])[0]
    s1 = int(slots[np.argmin(folded_deg(thetas[PROBE, slots], true1[PROBE]))])
    s2 = int(slots[np.argmin(folded_deg(thetas[PROBE, slots], true2[PROBE]))])
    trk1 = folded_deg(thetas[PROBE:, s1], true1[PROBE:])
    trk2 = folded_deg(thetas[PROBE:, s2], true2[PROBE:])
    fig_lines(centers, {
        "true 1": np.rad2deg(true1),
        "true 2": np.rad2deg(true2),
        "track A": np.rad2deg(np.where(confirmed[:, s1], thetas[:, s1], np.nan)),
        "track B": np.rad2deg(np.where(confirmed[:, s2], thetas[:, s2], np.nan)),
        "peaks (sorted)": np.rad2deg(z_sorted[:, 0]),
    }, "multi_target_tracking.pdf", xlabel="time [s]", ylabel="DoA [deg]")
    return {
        "snr_db": snr_db,
        "n_frames": n_frames,
        "confirmed_final": int(confirmed[-1].sum()),
        "identity_held": bool(max(trk1.max(), trk2.max()) < 15.0),
        "sorted_peaks_baseline_mae_deg": [float(np.nanmean(base1)), float(np.nanmean(base2))],
        "tracked_mae_deg": [float(trk1.mean()), float(trk2.mean())],
        "tracked_max_err_deg": [float(trk1.max()), float(trk2.max())],
    }


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--snr", type=float, default=10.0)
    ap.add_argument("--duration", type=float, help="recording, s (default 6, 1.2 with --quick)")
    ap.add_argument("--frame", type=float, help="frame, s (default 0.25, 0.1 with --quick)")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 65 with --quick)")
    args = ap.parse_args(argv)
    results = run(args.duration or (1.2 if args.quick else 6.0), args.snr, args.frame or (0.1 if args.quick else 0.25),
                  args.grid or (65 if args.quick else 32 * 7), args.device)
    res = {"experiment": "multi_target_tracking", "results": results}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
