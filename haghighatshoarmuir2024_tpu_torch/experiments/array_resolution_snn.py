"""Beam patterns of the float SNN beamformer, the port's twin of
``experiments/array_resolution_snn.py`` (paper_plots/array_resolution_snn.py,
the complex re-fold of the 2M-real vectors :156-160; the linear array of
array_resolution_linear_snn.py with jittered templates :173-181; the random
array of array_resolution_random_snn.py): design frequencies 1, 2 and 4 kHz
on a 7-mic circular, 7-mic linear (9 cm, a half-plane grid) or 13-mic
random array, the -3 dB beamwidths per frequency.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.array_resolution_snn \\
        [--geometry circular|linear|random] [--unipolar] [--quick] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry import CenterCircularArray, LinearArray, Random2DArray
from ..models.snn_beamformer import SNNBeamformer
from .common import FS, arg_parser, beam_pattern, fig_polar_patterns, jittered_sinusoid_template, widths

FREQS = (1_000.0, 2_000.0, 4_000.0)
KINDS = ("circular", "linear", "random")


def build_geometry(kind: str, num_grid: int = 16 * 7):
    """The array and its DoA grid (a half plane for the linear array)."""
    if kind == "circular":
        return CenterCircularArray(radius=4.5e-2, num_mic=7), np.linspace(-np.pi, np.pi, num_grid)
    if kind == "linear":  # a 7-mic ULA spanning 9 cm (array_resolution_linear_snn.py)
        return LinearArray(spacing=9e-2 / 6, num_mic=7, radius=None), np.linspace(-np.pi / 2, np.pi / 2, num_grid)
    if kind == "random":
        return Random2DArray(radius=4.5e-2, num_mic=13, seed=0), np.linspace(-np.pi, np.pi, num_grid)
    raise ValueError(kind)


def design(geometry, doa_list, freq_design: float, bipolar: bool = True, duration: float = 0.25, device=None):
    """The (2M, G) float32 design for ``freq_design`` (band [0.5, 1] x it,
    both time constants 1/(2π f_mid)) on a jittered sinusoid at f_mid."""
    freq_range = (0.5 * freq_design, freq_design)
    freq_mid = float(np.mean(freq_range))
    tau = 1.0 / (2 * np.pi * freq_mid)
    snn = SNNBeamformer(geometry, 10e-3, freq_range, [tau, tau], bipolar_spikes=bipolar, fs=FS, device=device)
    return snn.design_from_template(jittered_sinusoid_template(freq_mid, duration), doa_list)


def run(kind: str = "circular", bipolar: bool = True, num_grid: int = 16 * 7, duration: float = 0.25, device=None,
        freqs=FREQS) -> dict:
    """The widths per design frequency; with ``HM2024_FIG_DIR`` set, the
    patterns of the middle DoA also go to ``array_resolution_snn_{kind}.pdf``."""
    geometry, doa_list = build_geometry(kind, num_grid)
    results, pats = {}, {}
    for f in freqs:
        pattern = beam_pattern(design(geometry, doa_list, f, bipolar, duration, device), complex_fold=bipolar)
        results[f"{f:.0f}Hz"] = widths(pattern, doa_list)
        pats[f"{f:.0f} Hz"] = pattern[len(doa_list) // 2]
    fig_polar_patterns(pats, doa_list, f"array_resolution_snn_{kind}.pdf")
    return results


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--geometry", choices=KINDS, default="circular")
    ap.add_argument("--unipolar", action="store_true")
    ap.add_argument("--grid", type=int, help="DoA grid points (default 112, 17 with --quick)")
    ap.add_argument("--duration", type=float, help="template, s (default 0.25, 0.05 with --quick)")
    args = ap.parse_args(argv)
    results = run(args.geometry, not args.unipolar, args.grid or (17 if args.quick else 16 * 7),
                  args.duration or (0.05 if args.quick else 0.25), args.device)
    res = {"experiment": f"array_resolution_snn_{args.geometry}", "results": results}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
