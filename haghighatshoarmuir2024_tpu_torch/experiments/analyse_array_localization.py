"""The post-processing of collected benchmark runs, the port's twin of
``experiments/analyse_array_localization.py`` (itself the twin of
paper_plots/analyse_array_localization.py): each run's windowed median with
jump rejection (``utils.stats.window_median``), and its MAE (``utils.stats.mae``)
against a target: for the reference's three recorded bands the per-band
target medians it documents (:67-81), for other runs their own median.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.analyse_array_localization \\
        [DIR ...] [--quick] [--device cpu]

Analyses the ``.txt`` runs in each DIR, and the reference's recorded runs
when its checkout is present.  ``--quick`` first collects a run of 40
samples (the median window is 25) with ``snn_localization_benchmark`` at its
quick size on ``--device`` (the card unless ``cpu``) into
``$HM2024_BENCH_DIR`` and analyses that directory too.  Prints one
JSON object with the JAX twin's keys.  The analysis itself is host numpy.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.stats import mae, window_median
from .common import arg_parser
from .snn_localization_benchmark import REF_ROOT, bench_dir

REF_BANDS = {
    "demo-benchmark-simulation-freq1600-2000": 128.571429,
    "demo-benchmark-simulation-freq2000-2300": 129.375,
    "demo-benchmark-simulation-freq2300-2600": 132.589286,
}


def analyse_file(path: str, target: float, window_length: int = 25, reject_jump: float = 20.0) -> dict:
    data = np.loadtxt(path)
    post = window_median(data, window_length, reject_jump)
    return {
        "mae_vs_target": round(mae(post, target), 6),
        "mae_vs_run_median": round(mae(post, float(np.median(data))), 6),
        "run_median": round(float(np.median(data)), 4),
    }


def analyse(extra_dirs=()) -> dict:
    """The reference's recorded bands where present, then every ``.txt`` run
    of ``extra_dirs`` against its own median (JAX ``main``)."""
    out = {}
    for band, target in REF_BANDS.items():
        d = os.path.join(REF_ROOT, band)
        if os.path.isdir(d):
            out[band] = {f: analyse_file(os.path.join(d, f), target) for f in sorted(os.listdir(d))}
    for d in extra_dirs:
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                if f.endswith(".txt"):
                    path = os.path.join(d, f)
                    out.setdefault(os.path.basename(d), {})[f] = analyse_file(path, float(np.median(np.loadtxt(path))))
    return out


def main(argv=None) -> dict:
    ap = arg_parser(__doc__)  # --quick: collect 40 samples at the benchmark's quick size first
    ap.add_argument("dirs", nargs="*", help="directories of collected runs")
    args = ap.parse_args(argv)
    dirs = list(args.dirs)
    if args.quick:
        from . import snn_localization_benchmark as bench

        bench.main(["--quick", "--samples", "40"] + (["--device", args.device] if args.device else []))
        dirs.append(bench_dir())
    res = {"experiment": "analyse_array_localization", "results": analyse(dirs)}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
