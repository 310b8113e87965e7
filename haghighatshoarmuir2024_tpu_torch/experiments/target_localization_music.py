"""Monte-Carlo DoA accuracy of the MUSIC beamformer, the port's twin of
``experiments/target_localization_music.py`` (paper_plots/
target_localization_MUSIC.py: one active bin of a 2048-bin FFT, :65-67):
the Hilbert harness's tone and speech, synthesized with the reference's
MUSIC convention (``t − delay``, ``delay_sign=-1``: the steering is
physical, and plus-convention audio mirrors the raw estimates by 180°).

    python -m haghighatshoarmuir2024_tpu_torch.experiments.target_localization_music \\
        [--quick] [--sims N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  A batch of trials goes
through ``MUSIC.beamforming`` (B, T, M) in one bandpass scan.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry import CenterCircularArray
from ..models.music import MUSIC
from .common import FS, arg_parser, fig_mae_vs_snr, mc_sweep, summarize
from .target_localization import FREQ_RANGE, template

NUM_ACTIVE_FREQ = 1
NUM_FFT_BIN = 2048


def build(num_grid: int = 32 * 7, duration: float = 0.25, device=None) -> MUSIC:
    return MUSIC(CenterCircularArray(radius=4.5e-2, num_mic=7), FREQ_RANGE, np.linspace(-np.pi, np.pi, num_grid),
                 frame_duration=duration, fs=FS, device=device)


def profile_fn(music: MUSIC):
    """(B, T, M) frames → (B, G) Bartlett spectra on the dominant bin."""
    return lambda frames: music.beamforming(frames, NUM_ACTIVE_FREQ, NUM_FFT_BIN)


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7, seed: int = 0, duration: float = 0.25,
        speech_duration: float = 1.0, device=None, draws=None, model=None):
    music = model or build(num_grid, duration, device)
    t, sig = template(target, duration, speech_duration)
    return mc_sweep(profile_fn(music), music.doa_list, music.geometry, t, sig, num_sims, seed, music.device,
                    delay_sign=-1, draws=draws)


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--sims", type=int, help="tone trials a SNR (default 100, 4 with --quick; speech a fifth)")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="tone frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    sims = args.sims or (4 if args.quick else 100)
    duration = args.duration or (0.05 if args.quick else 0.25)
    music = build(args.grid or (17 if args.quick else 32 * 7), duration, args.device)
    out = {target: summarize(run(target, n, duration=duration, speech_duration=duration if args.quick else 1.0,
                                 model=music))
           for target, n in (("tone", sims), ("speech", max(sims // 5, 2)))}
    fig_mae_vs_snr({t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out}, "target_localization_music_mae.pdf")
    res = {"experiment": "target_localization_music", "results": out}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
