"""Angular resolution of the MUSIC beamformer, the port's twin of
``experiments/array_resolution_music.py`` (paper_plots/array_resolution_music.py
and its linear- and random-array variants): the angular power spectrum of
``MUSIC.apply_to_template`` for a source at 0 and at π/2 (not on the linear
array's half plane), at 20 dB, per design frequency (1, 2 and 4 kHz): the
peak's folded error and the -3 dB beamwidth.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.array_resolution_music \\
        [--geometry circular|linear|random] [--snr DB] [--quick] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The noise of each
spectrum comes from a ``torch.Generator`` seeded with 0 (JAX: ``PRNGKey(0)``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..models.music import MUSIC
from ..utils import to_numpy
from .array_resolution_snn import KINDS, build_geometry
from .common import FS, arg_parser, beamwidth_3db, fig_polar_patterns, folded_deg, sinusoid_template

FREQS = (1_000.0, 2_000.0, 4_000.0)
TARGETS = (("doa_0", 0.0), ("doa_pi_2", np.pi / 2))


def spectrum(music: MUSIC, t, sig, doa_target: float, snr_db, seed: int = 0) -> np.ndarray:
    """The mean over frames of ``apply_to_template``'s spectra (G,), one
    active bin of 2048, no overlap, the noise from a generator seeded with
    ``seed`` (``snr_db=None``: none)."""
    gen = torch.Generator(music.device).manual_seed(seed)
    return to_numpy(music.apply_to_template((t, sig, doa_target), num_active_freq=1, duration_overlap=0.0,
                                            num_fft_bin=2048, snr_db=snr_db, generator=gen)).mean(0)


def run(kind: str = "circular", snr_db=20.0, num_grid: int = 16 * 7, duration: float = 0.25, device=None,
        freqs=FREQS) -> dict:
    """The peak errors and widths per design frequency; with
    ``HM2024_FIG_DIR`` set, the spectra of the source at 0 also go to
    ``array_resolution_music_{kind}.pdf``."""
    geometry, doa_list = build_geometry(kind, num_grid)
    results, pats = {}, {}
    for freq_design in freqs:
        music = MUSIC(geometry, (0.5 * freq_design, freq_design), doa_list, frame_duration=duration, fs=FS,
                      device=device)
        t, sig = sinusoid_template(0.75 * freq_design, duration)
        entry = {}
        for name, doa_target in TARGETS:
            if kind == "linear" and doa_target > doa_list.max():
                continue
            aps = spectrum(music, t, sig, doa_target, snr_db)
            est = doa_list[int(np.argmax(aps))]
            if name == "doa_0":
                pats[f"{freq_design:.0f} Hz"] = aps
            entry[name] = {"peak_err_deg": float(folded_deg(est, doa_target)),
                           "beamwidth_3db_deg": beamwidth_3db(aps, doa_list)}
        results[f"{freq_design:.0f}Hz"] = entry
    # polar angular-response panels (paper_plots/array_resolution_music.py:95-180
    # figure style: the spectrum per design frequency, the source at 0)
    fig_polar_patterns(pats, doa_list, f"array_resolution_music_{kind}.pdf")
    return results


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--geometry", choices=KINDS, default="circular")
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--grid", type=int, help="DoA grid points (default 112, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="template and frame, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    results = run(args.geometry, args.snr, args.grid or (17 if args.quick else 16 * 7),
                  args.duration or (0.05 if args.quick else 0.25), args.device)
    res = {"experiment": f"array_resolution_music_{args.geometry}", "results": results}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
