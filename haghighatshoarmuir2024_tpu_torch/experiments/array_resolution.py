"""Beam patterns of the Hilbert beamformer, the port's twin of
``experiments/array_resolution.py`` (paper_plots/array_resolution.py: the
7-mic CenterCircularArray of radius 4.5 cm, design frequencies 1, 2, 3.6,
4 and 8 kHz :119, sinusoid or band-limited noise templates, the pattern
``|bfᴴ bf|``): the -3 dB beamwidth's mean and max over the grid per design
frequency.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.array_resolution \\
        [--template sin|noise] [--quick] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry import CenterCircularArray
from ..models.beamformer import Beamformer
from .common import (FS, arg_parser, bandlimited_noise_template, beam_pattern, fig_polar_patterns,
                     sinusoid_template, widths)

FREQS = (1_000.0, 2_000.0, 3_600.0, 4_000.0, 8_000.0)


def design(freq_design: float, template_kind: str, doa_list, duration: float = 0.25, device=None):
    """The (M, G) complex64 design for ``freq_design`` (band [0.5, 1] x it)
    on a sinusoid at it or on noise in the band."""
    freq_range = (0.5 * freq_design, freq_design)
    bf = Beamformer(CenterCircularArray(radius=4.5e-2, num_mic=7), 10e-3, freq_range, fs=FS, device=device)
    tpl = (sinusoid_template(freq_design, duration) if template_kind == "sin"
           else bandlimited_noise_template(freq_range, duration))
    return bf.design_from_template(tpl, doa_list)[0]


def run(template_kind: str = "sin", num_grid: int = 16 * 7, duration: float = 0.25, device=None,
        freqs=FREQS) -> dict:
    """The widths per design frequency; with ``HM2024_FIG_DIR`` set, the
    patterns of the middle DoA also go to ``array_resolution_{kind}.pdf``."""
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    results, pats = {}, {}
    for f in freqs:
        pattern = beam_pattern(design(f, template_kind, doa_list, duration, device))
        results[f"{f:.0f}Hz"] = widths(pattern, doa_list)
        pats[f"{f:.0f} Hz"] = pattern[num_grid // 2]
    fig_polar_patterns(pats, doa_list, f"array_resolution_{template_kind}.pdf")
    return results


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--template", choices=("sin", "noise"), default="sin")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 112, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="template, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    results = run(args.template, args.grid or (17 if args.quick else 16 * 7),
                  args.duration or (0.05 if args.quick else 0.25), args.device)
    res = {"experiment": f"array_resolution_{args.template}", "results": results}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
