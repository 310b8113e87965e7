"""Monte-Carlo DoA accuracy of the Hilbert beamformer, the port's twin of
``experiments/target_localization.py`` (paper_plots/target_localization.py:
MAE vs SNR in [-10, 20] dB, a random DoA per trial, the error
arcsin|sin(est − true)|, :210-300): a tone of 1500 Hz in the 1000-2000 Hz
band (100 trials a SNR) and speech (20).

    python -m haghighatshoarmuir2024_tpu_torch.experiments.target_localization \\
        [--quick] [--sims N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The estimate is the
argmax of ``mean(|out|²)`` over time; a batch of trials goes through
``Beamformer.apply_to_signal`` (B, T, M) in one bandpass scan.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry import CenterCircularArray
from ..models.beamformer import Beamformer
from .common import FS, arg_parser, fig_mae_vs_snr, mc_sweep, sinusoid_template, speech_template, summarize

FREQ_RANGE = (1_000.0, 2_000.0)  # [0.5, 1] x the 2 kHz design frequency
TONE = 1_500.0  # 0.75 x the design frequency


def build(num_grid: int = 32 * 7, duration: float = 0.25, device=None):
    """The beamformer designed on a tone of ``duration`` s: (bf, bf_mat, grid)."""
    grid = np.linspace(-np.pi, np.pi, num_grid)
    bf = Beamformer(CenterCircularArray(radius=4.5e-2, num_mic=7), 10e-3, FREQ_RANGE, fs=FS, device=device)
    bf_mat, _ = bf.design_from_template(sinusoid_template(TONE, duration), grid)
    return bf, bf_mat, grid


def profile_fn(bf, bf_mat):
    """(B, T, M) frames → (B, G) mean beam power ``mean(|out|²)``."""
    return lambda frames: (bf.apply_to_signal(bf_mat, frames).abs() ** 2).mean(dim=-2)


def template(target: str, duration: float, speech_duration: float):
    return sinusoid_template(TONE, duration) if target == "tone" else speech_template(duration=speech_duration)


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7, seed: int = 0, duration: float = 0.25,
        speech_duration: float = 1.0, device=None, draws=None, model=None):
    """One target's sweep; ``model`` = :func:`build`'s triple to reuse."""
    bf, bf_mat, grid = model or build(num_grid, duration, device)
    t, sig = template(target, duration, speech_duration)
    return mc_sweep(profile_fn(bf, bf_mat), grid, bf.geometry, t, sig, num_sims, seed, bf.device, draws=draws)


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--sims", type=int, help="tone trials a SNR (default 100, 4 with --quick; speech a fifth)")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="tone frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    sims = args.sims or (4 if args.quick else 100)
    grid = args.grid or (17 if args.quick else 32 * 7)
    duration = args.duration or (0.05 if args.quick else 0.25)
    model = build(grid, duration, args.device)
    out = {}
    for target, n in (("tone", sims), ("speech", max(sims // 5, 2))):
        out[target] = summarize(run(target, n, grid, duration=duration, speech_duration=1.0 if not args.quick
                                    else duration, model=model))
    fig_mae_vs_snr({t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out}, "target_localization_mae.pdf")
    res = {"experiment": "target_localization", "results": out}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
