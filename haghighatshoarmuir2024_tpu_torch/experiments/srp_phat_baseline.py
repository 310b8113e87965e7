"""Monte-Carlo DoA accuracy of the classical SRP-PHAT baseline, the port's
twin of ``experiments/srp_phat_baseline.py`` (beyond the reference, whose
families are Hilbert, SNN and MUSIC): the textbook GCC-PHAT steered power
under the Hilbert harness's conventions, on a 1750 Hz tone, a 1600-2600 Hz
chirp and speech, each with its band, synthesized with ``delay_sign=-1``
(the steering is physical, as MUSIC's).

    python -m haghighatshoarmuir2024_tpu_torch.experiments.srp_phat_baseline \\
        [--quick] [--sims N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  A batch of trials goes
through the batched ``SRPPHAT.apply_to_signal``.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry import CenterCircularArray
from ..models.srp_phat import SRPPHAT
from .common import (FS, arg_parser, chirp_template, fig_mae_vs_snr, mc_sweep, sinusoid_template,
                     speech_template, summarize)

TARGETS = ("tone", "chirp", "speech")


def template(target: str, duration: float = 0.25, speech_duration: float = 1.0):
    """The target's ``(t, sig)`` and the band its PHAT sums over."""
    if target == "tone":
        return sinusoid_template(1750.0, duration), [1400.0, 2100.0]
    if target == "chirp":
        return chirp_template((1600.0, 2600.0), duration), [1400.0, 2800.0]
    return speech_template(duration=speech_duration), [300.0, 4000.0]  # all voiced content


def build(target: str = "tone", num_grid: int = 32 * 7, duration: float = 0.25, speech_duration: float = 1.0,
          device=None):
    """The localizer for ``target``'s band and frame, and the template."""
    (t, sig), band = template(target, duration, speech_duration)
    srp = SRPPHAT(CenterCircularArray(radius=4.5e-2, num_mic=7), freq_range=band,
                  doa_list=np.linspace(-np.pi, np.pi, num_grid), fs=FS, frame_duration=t[-1] + 1.0 / FS,
                  device=device)
    return srp, (t, sig)


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7, seed: int = 0, duration: float = 0.25,
        speech_duration: float = 1.0, device=None, draws=None):
    srp, (t, sig) = build(target, num_grid, duration, speech_duration, device)
    return mc_sweep(srp.apply_to_signal, srp.doa_list, srp.geometry, t, sig, num_sims, seed, srp.device,
                    delay_sign=-1, draws=draws)


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--sims", type=int, help="tone and chirp trials a SNR (default 100, 4 with --quick; speech a "
                                             "fifth)")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="tone and chirp frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    sims = args.sims or (4 if args.quick else 100)
    grid = args.grid or (17 if args.quick else 32 * 7)
    duration = args.duration or (0.05 if args.quick else 0.25)
    out = {target: summarize(run(target, sims if target != "speech" else max(sims // 5, 2), grid,
                                 duration=duration, speech_duration=duration if args.quick else 1.0,
                                 device=args.device))
           for target in TARGETS}
    fig_mae_vs_snr({t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out}, "srp_phat_baseline_mae.pdf")
    res = {"experiment": "srp_phat_baseline", "results": out}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
