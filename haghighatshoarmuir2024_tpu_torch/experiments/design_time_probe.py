"""Where the cold start of a new configuration goes, the port's twin of
``experiments/design_time_probe.py``, at bench.py's configuration (one band
1600-1900 Hz, a 449-point grid): the beamformer design
``SNNBeamformer.design_from_template`` twice, first and warm, then
``Demo(..., use_cache=False)`` in full (the design, the quantization and the
spec assembly, the simulator's set-up), each synchronized on the card.

JAX's "compile share" is XLA's compilation; the port compiles nothing at a
call, so ``design_compile_share_s`` (the first call's time less the warm
call's) is here the first call's one-off set-up: the CUDA context, the
cuBLAS and cuSOLVER handles, and the host caches of the filter matrices.
JAX's persistent compilation cache has no counterpart.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.design_time_probe \\
        [--quick] [--device cpu]

Prints one JSON object with the JAX twin's keys.
"""
from __future__ import annotations

import json
import time

import numpy as np

from ..geometry import CenterCircularArray, resolve_device
from ..models.snn_beamformer import SNNBeamformer
from ..models.xylo import Demo
from .common import FS, arg_parser, sync


def run(num_grid: int = 64 * 7 + 1, device=None) -> dict:
    dev = resolve_device(device)
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, num_grid)
    band = [1600.0, 1900.0]
    tau = 1.0 / (2 * np.pi * float(np.mean(band)))
    bf = SNNBeamformer(geometry=geometry, kernel_duration=10e-3, freq_range=band, tau_vec=[tau, tau],
                       bipolar_spikes=True, fs=FS, device=dev)
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * float(np.mean(band)) * t)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    _, first = timed(lambda: bf.design_from_template((t, sig), grid).cpu())
    _, second = timed(lambda: bf.design_from_template((t, sig), grid).cpu())
    _, demo_total = timed(lambda: Demo(geometry=geometry, freq_bands=[band], doa_list=grid, recording_duration=0.25,
                                       kernel_duration=10e-3, bipolar_spikes=True, fs=FS, use_cache=False,
                                       device=dev))
    return {
        "experiment": "design_time_probe",
        "design_first_call_s": round(first, 2),
        "design_warm_call_s": round(second, 2),
        "design_compile_share_s": round(first - second, 2),
        "demo_init_total_s": round(demo_total, 2),
        "demo_minus_design_s": round(demo_total - second, 2),
    }


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)  # --quick: a 17-point grid
    res = run(17 if args.quick else 64 * 7 + 1, args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
