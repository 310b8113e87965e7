"""Monte-Carlo DoA accuracy of the float32 SNN beamformer, the port's twin
of ``experiments/target_snn_localization.py`` (paper_plots/
target_snn_localization.py: a chirp design template :126-134, the
bandwidth-corrected SNR :382-393, 11 SNRs): the bipolar SNN designed on a
1000-2000 Hz chirp, the same chirp as the "tone" target (100 trials a SNR)
and speech (20), the noise set by the bandwidth-corrected SNR and the
nominal SNR reported.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.target_snn_localization \\
        [--quick] [--sims N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The estimate is the
argmax of the mean squared membrane; a batch of trials goes through
``SNNBeamformer.apply_to_signal`` (B, T, M) in one bandpass scan.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry import CenterCircularArray
from ..models.snn_beamformer import SNNBeamformer
from ..parallel import snr_with_bandwidth_correction
from .common import (FS, arg_parser, chirp_template, fig_mae_vs_snr, mc_sweep, snr_sweep_config,
                     speech_template, summarize)

FREQ_RANGE = (1_000.0, 2_000.0)


def build(num_grid: int = 32 * 7, duration: float = 0.25, bipolar: bool = True, device=None):
    """The SNN designed on the chirp of ``duration`` s: (snn, bf_mat, grid)."""
    tau = 1.0 / (2 * np.pi * float(np.mean(FREQ_RANGE)))
    grid = np.linspace(-np.pi, np.pi, num_grid)
    snn = SNNBeamformer(CenterCircularArray(radius=4.5e-2, num_mic=7), 10e-3, FREQ_RANGE, [tau, tau],
                        bipolar_spikes=bipolar, fs=FS, device=device)
    return snn, snn.design_from_template(chirp_template(FREQ_RANGE, duration), grid), grid


def profile_fn(snn, bf_mat, t):
    """(B, T, M) frames on the time axis ``t`` → (B, G) mean squared membrane."""
    return lambda frames: (snn.apply_to_signal(bf_mat, (t, frames)) ** 2).mean(dim=-2)


def bandwidth_corrected_snrs() -> list:
    return [snr_with_bandwidth_correction(s, FS, FREQ_RANGE) for s in snr_sweep_config()]


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7, seed: int = 0, duration: float = 0.25,
        speech_duration: float = 1.0, device=None, draws=None, model=None):
    snn, bf_mat, grid = model or build(num_grid, duration, device=device)
    t, sig = chirp_template(FREQ_RANGE, duration) if target == "tone" else speech_template(duration=speech_duration)
    res = mc_sweep(profile_fn(snn, bf_mat, t), grid, snn.geometry, t, sig, num_sims, seed, snn.device,
                   snr_db_vec=bandwidth_corrected_snrs(), draws=draws)
    res["snr_db"] = snr_sweep_config()  # the nominal SNRs are reported
    return res


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--sims", type=int, help="tone trials a SNR (default 100, 4 with --quick; speech a fifth)")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 224, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="chirp frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    sims = args.sims or (4 if args.quick else 100)
    duration = args.duration or (0.05 if args.quick else 0.25)
    model = build(args.grid or (17 if args.quick else 32 * 7), duration, device=args.device)
    out = {target: summarize(run(target, n, duration=duration, speech_duration=duration if args.quick else 1.0,
                                 model=model))
           for target, n in (("tone", sims), ("speech", max(sims // 5, 2)))}
    fig_mae_vs_snr({t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out}, "target_snn_localization_mae.pdf")
    res = {"experiment": "target_snn_localization", "results": out}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
