"""Two-target resolution, the port's twin of ``experiments/multiple_targets.py``
(paper_plots/multiple_targets_{beamformer,music,snn}.py): two equal-power
tones at ±60° (multiple_targets_snn.py:194-195), summed per target
(:87-159), plus white noise at 20 dB; the two best-separated peaks of the
Hilbert beamformer's response (with and without interference removal),
MUSIC's (Bartlett, and the noise subspace of two sources) and the float
SNN's.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.multiple_targets \\
        [--snr DB] [--quick] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  MUSIC gets the
reference's MUSIC synthesis (``t − delay``, multiple_targets_music.py:147),
Hilbert and SNN the plus convention (multiple_targets_snn.py:147); the noise
comes from ``numpy.random.default_rng(0)``, as in JAX.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.beamformer import Beamformer
from ..models.music import MUSIC
from ..models.snn_beamformer import SNNBeamformer
from ..ops.interp import signal_from_template
from ..ops.peaks import find_peaks_mask
from ..utils import to_numpy
from .common import FS, arg_parser, fig_polar_patterns, sinusoid_template

FREQ_DESIGN = 2_000.0
FREQ_RANGE = (0.5 * FREQ_DESIGN, FREQ_DESIGN)
TARGETS = np.array([-np.pi / 3, np.pi / 3])  # ±60 deg


def signal_multiple_targets(geometry, time_temp, sig_temps, doas, powers=None, delay_sign: int = 1) -> np.ndarray:
    """The (T, M) float64 sum of each target's delayed copy scaled by
    ``sqrt(power)`` (paper_plots/multiple_targets_snn.py:87-159), on the host."""
    powers = powers or [1.0] * len(doas)
    t = torch.as_tensor(np.asarray(time_temp, np.float64))
    return sum(np.sqrt(p) * signal_from_template(geometry, t, torch.as_tensor(np.asarray(s, np.float64)), float(d),
                                                 fs=FS, delay_sign=delay_sign).numpy()
               for s, d, p in zip(sig_temps, doas, powers))


def detect_peaks(profile, doa_list, num: int = 2) -> np.ndarray:
    """The ``num`` highest of the profile's peaks at least G // 16 apart, as
    sorted DoAs."""
    profile = np.asarray(profile)
    mask = find_peaks_mask(torch.as_tensor(profile), distance=len(doa_list) // 16).numpy()
    idx = np.nonzero(mask)[0]
    idx = idx[np.argsort(profile[idx])[::-1]][:num]
    return np.sort(doa_list[idx])


def mixtures(geometry, snr_db: float = 20.0, duration: float = 0.25, seed: int = 0):
    """The template axis, the first tone, and the two noisy mixtures (plus
    convention, then MUSIC's), the noise drawn in that order from ``seed``."""
    t, sig1 = sinusoid_template(0.75 * FREQ_DESIGN, duration)
    _, sig2 = sinusoid_template(0.80 * FREQ_DESIGN, duration)
    rng = np.random.default_rng(seed)
    out = []
    for sign in (1, -1):
        x = signal_multiple_targets(geometry, t, [sig1, sig2], TARGETS, delay_sign=sign)
        out.append(x + np.sqrt(np.mean(x**2) / 10 ** (snr_db / 10)) * rng.standard_normal(x.shape))
    return t, sig1, out[0], out[1]


def run(snr_db: float = 20.0, num_grid: int = 32 * 7, duration: float = 0.25, device=None, signals=None) -> dict:
    """Each method's detections in degrees; ``signals`` = :func:`mixtures`'
    ``(sig_in, sig_in_music)`` to use instead.  With ``HM2024_FIG_DIR`` set,
    the Hilbert (with interference removal), MUSIC and SNN profiles also go
    to ``multiple_targets.pdf``."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    t, sig1, sig_in, sig_in_m = mixtures(geometry, snr_db, duration)
    if signals is not None:
        sig_in, sig_in_m = signals
    deg = lambda prof: np.rad2deg(detect_peaks(to_numpy(prof), doa_list)).tolist()  # noqa: E731
    out = {}
    # Hilbert (interference removal improves the separation)
    for ir in (False, True):
        bf = Beamformer(geometry, 10e-3, FREQ_RANGE, fs=FS, device=device)
        bf_mat, _ = bf.design_from_template((t, sig1), doa_list, interference_removal=ir)
        prof = (bf.apply_to_signal(bf_mat, sig_in).abs() ** 2).mean(dim=0)
        out[f"hilbert{'_ir' if ir else ''}"] = {"detected_deg": deg(prof)}
    music = MUSIC(geometry, FREQ_RANGE, doa_list, frame_duration=duration, fs=FS, device=device)
    aps = music.beamforming(sig_in_m, 2, 2048)
    out["music"] = {"detected_deg": deg(aps)}
    # beyond the reference: the noise subspace resolves the pair far more sharply than its Bartlett scan
    out["music_ns2"] = {"detected_deg": deg(music.beamforming(sig_in_m, 2, 2048, num_sources=2))}
    tau = 1.0 / (2 * np.pi * float(np.mean(FREQ_RANGE)))
    snn = SNNBeamformer(geometry, 10e-3, FREQ_RANGE, [tau, tau], bipolar_spikes=True, fs=FS, device=device)
    bf_snn = snn.design_from_template((t, sig1), doa_list)
    prof_snn = (snn.apply_to_signal(bf_snn, (t, sig_in)) ** 2).mean(dim=0)
    out["snn"] = {"detected_deg": deg(prof_snn)}
    out["targets_deg"] = np.rad2deg(TARGETS).tolist()
    fig_polar_patterns({"hilbert": to_numpy(prof), "music": to_numpy(aps), "snn": to_numpy(prof_snn)}, doa_list,
                       "multiple_targets.pdf")
    return out


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 33 with --quick)")
    ap.add_argument("--duration", type=float, help="templates and frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    out = run(args.snr, args.grid or (33 if args.quick else 32 * 7), args.duration or (0.05 if args.quick else 0.25),
              args.device)
    res = {"experiment": "multiple_targets", "results": out}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
