"""Multi-band quantized-pipeline accuracy on speech, the port's twin of
``experiments/multiband_speech.py``.

The reference's quantized deployments are single-band by hardware necessity
(micloc/xylo_snn_localization.py:596-601).  Speech is wideband, so this
harness runs the speech Monte Carlo through a single band ``[1000, 2000]``
and through three bands ``[500-1000 | 1000-2000 | 2000-3000]`` (a software
deployment, ``enforce_hw_limits=False``) on the same grid, template and
trials, with every estimator read from one forward a trial batch:

- single band: the reference's windowed peak and the matched estimator
  (speech-calibrated, folded);
- three bands: the same two, the band-stacked matched correlation, the
  per-band cosine, the per-band cosine plus the folded cosine, and the
  SNR-adaptive blends weighted ``peak``, ``peak2`` and ``contrast``, all
  through the scorers ``models/xylo/pipeline.py`` ships
  (``_blockcos``, ``_cos1``, ``_auto_blend_scores``).

:func:`run_cross_segment` scores the three-band model's per-band cosine with
profiles calibrated on the trials' segment of the utterance and on the next
one (``speech_template(segment=1)``).  On the synthetic fallback, which is
exactly ``duration`` long, the two segments are one window (JAX
``common.py:108``), as in the JAX package.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.multiband_speech \
        [--quick] [--sims N] [--cross-segment] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  On the card each trial
batch runs encode → K1 → K2 → pack → K3 (C = 42, N = 3·G for three bands).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.xylo import Demo
from ..models.xylo.pipeline import _auto_blend_scores, _blockcos, _cos1
from ..ops.fir import full_fp32
from ..parallel import make_trial_fn, monte_carlo_sweep
from .common import FS, fig_mae_vs_snr, speech_template
from .target_xylo_localization import reference_doa

SNRS = [-10.0, -4.0, 2.0, 8.0, 14.0, 20.0]
CROSS_SNRS = [-4.0, 8.0, 20.0]
SINGLE_BAND = [[1000.0, 2000.0]]
THREE_BANDS = [[500.0, 1000.0], [1000.0, 2000.0], [2000.0, 3000.0]]
CHUNK = 16  # trials a forward (JAX's chunk)
THREE_BAND_COLUMNS = ("reference_peak", "matched_speech_cal", "matched_band_stacked", "matched_band_cos",
                      "matched_band_cosfold", "matched_auto_peak", "matched_auto_peak2", "matched_auto_contrast")


def build_demo(bands, num_grid: int = 16 * 7, duration: float = 1.0, device=None) -> Demo:
    """The harness's bipolar model of ``bands`` on a ``num_grid``-point grid,
    designed with a ``duration`` s tone; several bands are a software
    deployment (``enforce_hw_limits=False``)."""
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=bands,
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=duration, kernel_duration=10e-3,
                bipolar_spikes=True, fs=FS, enforce_hw_limits=len(bands) == 1, device=device)


def doas_from_rate(demo, rate: torch.Tensor, prof_folded: torch.Tensor, prof_stacked=None) -> torch.Tensor:
    """A trial batch's estimators, unfolded rates (B, F·G) → (B, K) DoAs
    (JAX ``_mc_config.trial_chunk``): the peak and the folded matched
    correlation, and with the band-stacked table the six of
    ``THREE_BAND_COLUMNS[2:]``; float32 products, TF32 off."""
    full_fp32()
    G = len(demo.doa_list)
    grid = demo._doa_t
    folded = demo.fold(rate)
    ests = [reference_doa(demo, folded)]
    rc = folded - folded.mean(dim=-1, keepdim=True)
    ests.append(grid[torch.argmax(rc @ prof_folded.T, dim=-1)])
    if prof_stacked is not None:
        ru = rate - rate.mean(dim=-1, keepdim=True)
        ests.append(grid[torch.argmax(ru @ prof_stacked.T, dim=-1)])
        s3 = _blockcos(rate, G) @ _blockcos(prof_stacked, G).T  # the per-band cosine
        ests.append(grid[torch.argmax(s3, dim=-1)])
        s4 = s3 + _cos1(folded) @ _cos1(prof_folded).T  # plus the folded profile's cosine
        ests.append(grid[torch.argmax(s4, dim=-1)])
        for weight in ("peak", "peak2", "contrast"):
            ests.append(grid[torch.argmax(_auto_blend_scores(rate, prof_stacked, G, weight=weight), dim=-1)])
    return torch.stack(ests, dim=-1)


def speech_tables(demo, t_sp, sig_sp, stacked: bool = False):
    """The matched tables calibrated on the speech, on the demo's device:
    the folded one, and the band-stacked one with ``stacked`` (else None)."""
    as_t = lambda p: torch.as_tensor(np.asarray(p, np.float32), device=demo.device)  # noqa: E731
    prof_folded = as_t(demo.calibrate_profiles(template=(t_sp, sig_sp)))
    return prof_folded, (as_t(demo.calibrate_profiles(template=(t_sp, sig_sp), band_stacked=True))
                         if stacked else None)


def mc_config(demo, t_sp, sig_sp, num_sims: int, seed: int, stacked: bool = False, draws=None) -> np.ndarray:
    """The Monte Carlo of one model on speech trials (JAX ``_mc_config``):
    the profiles calibrated on the speech (folded, and band-stacked with
    ``stacked``), ``CHUNK`` trials a forward at the SNRs of ``SNRS``, the
    ``monte_carlo_sweep`` errors (num_snr, num_sims, K) in radians;
    ``draws`` replays given DoAs and noise."""
    tables = speech_tables(demo, t_sp, sig_sp, stacked)
    trial = make_trial_fn(demo.geometry, t_sp, sig_sp, lambda f: doas_from_rate(demo, demo.rates_batch(f), *tables),
                          FS, device=demo.device)
    return monte_carlo_sweep(trial, SNRS, num_sims, seed, CHUNK, draws=draws)["errors"]


def mae_cols(errs: np.ndarray, columns) -> dict:
    """MAE per SNR in degrees, rounded to 0.01 as JAX prints it, one list a column."""
    return {f"{c}_mae_deg": np.degrees(errs[:, :, k].mean(1)).round(2).tolist() for k, c in enumerate(columns)}


def run(num_sims: int = 50, num_grid: int = 16 * 7, seed: int = 0, duration: float = 1.0, device=None, demos=None,
        draws=None) -> dict:
    """Single band against three bands on the same speech trials (JAX
    ``run``).  ``demos = (single, three)`` takes built models; ``draws``
    replays given DoAs and noise in both."""
    t_sp, sig_sp = speech_template(duration=duration)
    demo1, demo3 = demos or (build_demo(SINGLE_BAND, num_grid, duration, device),
                             build_demo(THREE_BANDS, num_grid, duration, device))
    res = {"snr_db": SNRS, "num_sims": num_sims, "num_grid": num_grid}
    e1 = mc_config(demo1, t_sp, sig_sp, num_sims, seed, draws=draws)
    res["single_band_1000_2000"] = mae_cols(e1, THREE_BAND_COLUMNS[:2])
    e3 = mc_config(demo3, t_sp, sig_sp, num_sims, seed, stacked=True, draws=draws)
    res["three_band_500_3000"] = {"freq_bands": THREE_BANDS, **mae_cols(e3, THREE_BAND_COLUMNS)}
    return res


def run_cross_segment(num_sims: int = 50, num_grid: int = 16 * 7, seed: int = 0, duration: float = 1.0, device=None,
                      demo=None, draws=None) -> dict:
    """The three-band per-band cosine with band-stacked profiles calibrated
    on the trials' segment and on the next (JAX ``run_cross_segment``), at
    ``CROSS_SNRS``, ``CHUNK`` trials a forward."""
    t_eval, sig_eval = speech_template(duration=duration, segment=0)
    t_cal, sig_cal = speech_template(duration=duration, segment=1)
    demo = demo or build_demo(THREE_BANDS, num_grid, duration, device)
    G = len(demo.doa_list)
    as_t = lambda p: torch.as_tensor(np.asarray(p, np.float32), device=demo.device)  # noqa: E731
    prof_cos = {k: _blockcos(as_t(demo.calibrate_profiles(template=tpl, band_stacked=True)), G)
                for k, tpl in (("self_segment", (t_eval, sig_eval)), ("cross_segment", (t_cal, sig_cal)))}

    def estimate(frames):
        full_fp32()
        rc = _blockcos(demo.rates_batch(frames), G)
        return torch.stack([demo._doa_t[torch.argmax(rc @ p.T, dim=-1)] for p in prof_cos.values()], dim=-1)

    trial = make_trial_fn(demo.geometry, t_eval, sig_eval, estimate, FS, device=demo.device)
    errs = monte_carlo_sweep(trial, CROSS_SNRS, num_sims, seed, CHUNK, draws=draws)["errors"]
    return {"snr_db": CROSS_SNRS, **mae_cols(errs, list(prof_cos))}


def figures(res: dict) -> None:
    """With ``HM2024_FIG_DIR`` set: the MAE-vs-SNR curves of one band
    against three (JAX's figure)."""
    snr = res["snr_db"]
    one, three = res["single_band_1000_2000"], res["three_band_500_3000"]
    fig_mae_vs_snr({
        "single band, matched": (snr, one["matched_speech_cal_mae_deg"]),
        "3 bands, matched (folded)": (snr, three["matched_speech_cal_mae_deg"]),
        "3 bands, matched_stacked (cos)": (snr, three["matched_band_cos_mae_deg"]),
        "single band, reference peak": (snr, one["reference_peak_mae_deg"]),
    }, "multiband_speech_mae.pdf")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="8 trials a SNR")
    ap.add_argument("--sims", type=int, help="trials a SNR (default 50)")
    ap.add_argument("--cross-segment", action="store_true", help="calibrate on another segment of the speech")
    ap.add_argument("--grid", type=int, default=16 * 7)
    ap.add_argument("--duration", type=float, default=1.0, help="template and frame length, s")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    sims = args.sims or (8 if args.quick else 50)
    kw = dict(num_sims=sims, num_grid=args.grid, duration=args.duration, device=args.device)
    if args.cross_segment:
        out = {"experiment": "multiband_speech_cross_segment", "results": run_cross_segment(**kw)}
    else:
        out = {"experiment": "multiband_speech", "results": run(**kw)}
        figures(out["results"])
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
