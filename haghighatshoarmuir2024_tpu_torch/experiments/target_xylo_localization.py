"""Monte-Carlo DoA accuracy of the quantized Xylo pipeline, the port's twin
of ``experiments/target_xylo_localization.py`` (reference:
paper_plots/target_xylo_localization.py, bipolar 100 trials, and
target_xylo_unipolar_localization.py, unipolar 20): a random DoA per
trial, the 11-point SNR sweep, two estimators on the same trials, and the
spread of the reference estimator over the simulator's four step
conventions.

``--speech`` runs the speech-target harness (:func:`run_speech`; reference
paper_plots/target_xylo_localization.py:123-394): fixed-DoA beam profiles at
the bandwidth-corrected SNR, the 11-SNR speech Monte Carlo with the
reference estimator and the matched one calibrated on the tone and on the
speech, and the calibration-robustness table of tone, chirp and speech
trials.  The speech is the LibriSpeech sample where it is present, else
the synthetic fallback of ``common.speech_template``.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.target_xylo_localization \
        [--speech] [--unipolar] [--quick] [--sims N] [--grid G] [--duration S] [--device cpu]

Prints one JSON object with the JAX twin's keys.  The trials run in
batches through ``Demo.forward_batch``'s path (encode → K1 → K2 → pack →
K3 on the card; a unipolar model's raster pack → K5), the envelope through
``sim_hidden_batch``.
"""
from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from ..geometry import CenterCircularArray
from ..models.xylo import Demo
from ..models.xylo.sim import ORDERINGS, RESETS, sim_hidden_batch
from ..ops.fir import full_fp32
from ..ops.interp import signal_from_template
from ..parallel import make_trial_fn, monte_carlo_sweep, snr_with_bandwidth_correction, synthesize_batch
from ..utils.peak_location import find_peak_location
from .common import (FS, chirp_template, fig_lines, fig_mae_vs_snr, sinusoid_template, snr_sweep_config,
                     speech_template, summarize)

VARIANTS = list(itertools.product(ORDERINGS, RESETS))
FREQ_RANGE = (1_000.0, 2_000.0)  # [0.5, 1] x the 2 kHz design frequency


def peak_window(num_grid: int) -> int:
    """The reference estimator's averaging window: grid // 32 made odd
    (paper_plots/target_xylo_localization.py:326-333)."""
    win = num_grid // 32
    return 2 * (win // 2) + 1


def reference_doa(demo, rate: torch.Tensor) -> torch.Tensor:
    """The reference estimator: the moving-average peak of each folded rate
    row (B, G), the plain argmax when the window is 1."""
    win = peak_window(len(demo.doa_list))
    idx = find_peak_location(rate, win) if win > 1 else torch.argmax(rate, dim=-1)
    return demo._doa_t[idx]


def build_demo(bipolar: bool = True, num_grid: int = 16 * 7, duration: float = 0.25, device=None) -> Demo:
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[list(FREQ_RANGE)],
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=duration,
                kernel_duration=10e-3, bipolar_spikes=bipolar, fs=FS, device=device)


def run(bipolar: bool = True, num_sims: int = 100, num_grid: int = 16 * 7, seed: int = 0, envelope: bool = True,
        duration: float = 0.25, device=None, batch_size=None, demo=None):
    """Both estimators' sweeps (``monte_carlo_sweep`` dicts) and, with
    ``envelope``, the convention envelope at min(num_sims, 25) trials."""
    demo = demo or build_demo(bipolar, num_grid, duration, device)
    t, sig = sinusoid_template(float(np.mean(FREQ_RANGE)), duration)

    def estimate(frames):
        return reference_doa(demo, demo.fold(demo.rates_batch(frames)))

    trial = make_trial_fn(demo.geometry, t, sig, estimate, FS, device=demo.device)
    out = {"reference_estimator": monte_carlo_sweep(trial, snr_sweep_config(), num_sims, seed, batch_size)}

    demo.calibrate_profiles(template=(t, sig))
    trial_m = make_trial_fn(demo.geometry, t, sig, lambda f: demo.forward_batch(f, method="matched")[0], FS,
                            device=demo.device)
    out["matched_estimator"] = monte_carlo_sweep(trial_m, snr_sweep_config(), num_sims, seed, batch_size)
    if envelope:
        out["reference_estimator_convention_envelope"] = convention_envelope(
            demo, t, sig, snr_sweep_config(), num_sims=min(num_sims, 25), seed=seed)
    return out


def convention_envelope(demo, t, sig, snr_db_vec, num_sims: int = 25, seed: int = 0, batch=None) -> dict:
    """Min-max MAE (degrees) of the reference-parity peak estimator over the
    four step conventions of the simulator (JAX ``convention_envelope``):
    every convention sees the same input rasters, so the spread is the
    convention's alone.  The draws are JAX's (numpy, ``seed``): DoAs in
    [-π, π), then per SNR float32 noise of the frames' shape.  All SNRs'
    frames go through ``batch`` rows at a time (all at once when None)."""
    G = len(demo.doa_list)
    grid = demo._doa_t
    rng = np.random.default_rng(seed)
    doa_true = rng.uniform(-np.pi, np.pi, size=num_sims)
    t64 = torch.as_tensor(np.asarray(t), dtype=torch.float64, device=demo.device)
    s64 = torch.as_tensor(np.asarray(sig), dtype=torch.float64, device=demo.device)
    clean = synthesize_batch(demo.geometry, t64, s64, torch.as_tensor(doa_true, device=demo.device), FS)
    clean = clean.to(torch.float32)
    sig_pow = torch.mean(clean**2, dim=(1, 2), keepdim=True)
    frames = []
    for snr_db in snr_db_vec:
        sigma = torch.sqrt(sig_pow / 10 ** (snr_db / 10))
        noise = rng.standard_normal(tuple(clean.shape)).astype(np.float32)
        frames.append(clean + sigma * torch.as_tensor(noise, device=demo.device))
    frames = torch.cat(frames)  # (S * num_sims, T, M)
    truth = torch.as_tensor(np.tile(doa_true, len(snr_db_vec)), device=demo.device)
    batch = batch or frames.shape[0]
    errs = {v: [] for v in VARIANTS}
    for s0 in range(0, frames.shape[0], batch):
        spikes_in = demo.spike_encoding(frames[s0:s0 + batch])
        for ordering, reset in VARIANTS:
            spk = sim_hidden_batch(demo.xylo_config, spikes_in, ordering=ordering, reset=reset, device=demo.device)
            rate = spk.to(torch.float32).mean(dim=1).reshape(spk.shape[0], -1, G).mean(dim=1)
            est = grid[torch.argmax(rate, dim=-1)]
            err = torch.abs(torch.arcsin(torch.abs(torch.sin(est - truth[s0:s0 + batch]))))
            errs[(ordering, reset)].append(torch.rad2deg(err).cpu().numpy())
    per_variant = {f"{o}/{r}": [float(m) for m in np.concatenate(errs[(o, r)]).reshape(len(snr_db_vec), -1)
                                .mean(axis=1)] for o, r in VARIANTS}
    S = len(snr_db_vec)
    return {
        "snr_db": [float(s) for s in snr_db_vec],
        "num_sims": num_sims,
        "mae_deg_by_variant": per_variant,
        "mae_deg_min": [float(min(v[i] for v in per_variant.values())) for i in range(S)],
        "mae_deg_max": [float(max(v[i] for v in per_variant.values())) for i in range(S)],
    }


# --------------------------------------------------------------------- speech
BEAM_SNRS = (-10.0, 0.0, 10.0, 20.0)  # stage A, bandwidth-corrected
ROBUST_SNRS = [-10.0, 0.0, 10.0, 20.0]  # stage C
SPEECH_LABELS = ("reference_peak", "matched_tone_cal", "matched_speech_cal")
SPEECH_BATCH = 20  # trials a forward in stages B and C (JAX's batch_size)


def speech_estimators(demo, rate: torch.Tensor, profiles) -> torch.Tensor:
    """(B, G) folded rates → (B, 1 + len(profiles)) DoAs: the reference
    estimator, then the matched argmax of ``p @ (rate − mean(rate))`` for
    each (G, G) table ``p`` of ``profiles``, float32 products (JAX
    ``run_speech.estimators``)."""
    full_fp32()
    r = rate - rate.mean(dim=-1, keepdim=True)
    ests = [reference_doa(demo, rate)] + [demo._doa_t[torch.argmax(r @ p.T, dim=-1)] for p in profiles]
    return torch.stack(ests, dim=-1)


def beam_frames(demo, t_sp, sig_sp, seed: int = 0) -> np.ndarray:
    """Stage A's frames (len(BEAM_SNRS), T, M) float32: the speech at DoA 0
    synthesized on the demo's device, plus numpy noise from
    ``default_rng(seed)`` at each bandwidth-corrected SNR of ``BEAM_SNRS``
    (JAX's draws)."""
    t32 = torch.as_tensor(t_sp, dtype=torch.float32, device=demo.device)
    s32 = torch.as_tensor(sig_sp, dtype=torch.float32, device=demo.device)
    fixed = signal_from_template(demo.geometry, t32, s32, 0.0, fs=FS).cpu().numpy()
    rng = np.random.default_rng(seed)
    sig_pow = float(np.mean(fixed**2))
    noisy = []
    for snr_db in BEAM_SNRS:
        sigma = np.sqrt(sig_pow / 10 ** (snr_with_bandwidth_correction(snr_db, FS, FREQ_RANGE) / 10))
        noisy.append((fixed + sigma * rng.standard_normal(fixed.shape)).astype(np.float32))
    return np.stack(noisy)


def run_speech(bipolar: bool = True, num_sims: int = 100, num_grid: int = 16 * 7, seed: int = 0,
               duration: float = 1.0, device=None, demo=None, draws=None, robust_draws=None) -> dict:
    """The speech-target harness (JAX ``run_speech``): the model of the tone
    harness designed with a 1.0 s template, trials of ``duration`` s.

    - A: the speech at DoA 0 with numpy noise from ``default_rng(seed)`` at
      the bandwidth-corrected SNRs of ``BEAM_SNRS`` (:func:`beam_frames`;
      JAX's draws, so the same noise arrays): each profile's three errors
      and its sidelobe;
    - B: the 11-SNR Monte Carlo of speech trials, the reference estimator
      and the matched one calibrated on the tone and on the speech, read
      from one forward of ``SPEECH_BATCH`` trials (``monte_carlo_sweep``
      seeded ``seed``, or JAX's ``draws = (doa_true, noise)`` replayed);
    - C: tone, chirp and speech trials at ``ROBUST_SNRS``, each scored with
      the tone-calibrated and the self-calibrated table (seeded ``seed + 1``
      for all three, as JAX keys them, or ``robust_draws``).

    Returns JAX's dict: ``beam_profiles``, ``speech_mc``,
    ``calibration_robustness``."""
    demo = demo or build_demo(bipolar, num_grid, 1.0, device)
    dev = demo.device
    t_sp, sig_sp = speech_template(duration=duration)
    t_ch, sig_ch = chirp_template(FREQ_RANGE, duration)
    t_tone, sig_tone = sinusoid_template(float(np.mean(FREQ_RANGE)), duration)
    as_t = lambda p: torch.as_tensor(np.asarray(p, np.float32), device=dev)  # noqa: E731
    p_tone = as_t(demo.calibrate_profiles())  # the design tone over the model's 1.0 s
    p_chirp = as_t(demo.calibrate_profiles(template=(t_ch, sig_ch)))
    p_speech = as_t(demo.calibrate_profiles(template=(t_sp, sig_sp)))

    def rates(frames):
        return demo.fold(demo.rates_batch(frames))

    # ---- A: fixed DoA 0, bandwidth-corrected SNR, JAX's numpy noise
    rate_a = rates(beam_frames(demo, t_sp, sig_sp, seed))
    est_a = speech_estimators(demo, rate_a, [p_tone, p_speech]).cpu().numpy()
    beam = {}
    for snr_db, rate, est in zip(BEAM_SNRS, rate_a.cpu().numpy(), est_a):
        power = rate / max(rate.max(), 1e-12)
        err = np.degrees(np.arcsin(np.abs(np.sin(est))))
        beam[f"{snr_db:+.0f}dB"] = {
            "peak_err_deg": float(err[0]),
            "matched_tone_err_deg": float(err[1]),
            "matched_speech_err_deg": float(err[2]),
            "sidelobe_db": float(10 * np.log10(max(np.partition(power, -2)[-2], 1e-12))),
            "profile": power.tolist(),
        }

    # ---- B: the speech Monte Carlo, three estimators from one forward
    trial = make_trial_fn(demo.geometry, t_sp, sig_sp,
                          lambda f: speech_estimators(demo, rates(f), [p_tone, p_speech]), FS, device=dev)
    errs = monte_carlo_sweep(trial, snr_sweep_config(), num_sims, seed, SPEECH_BATCH, draws=draws)["errors"]
    mc = {"snr_db": [float(s) for s in snr_sweep_config()],
          **{lab: {"mae_deg": [float(np.degrees(m)) for m in errs[:, :, k].mean(axis=1)],
                   "median_deg": [float(np.degrees(m)) for m in np.median(errs[:, :, k], axis=1)]}
             for k, lab in enumerate(SPEECH_LABELS)}}

    # ---- C: each template with the tone-calibrated and the self-calibrated table
    robustness = {}
    for name, (t_e, s_e, p_self) in {"tone": (t_tone, sig_tone, p_tone), "chirp": (t_ch, sig_ch, p_chirp),
                                     "speech": (t_sp, sig_sp, p_speech)}.items():
        trial = make_trial_fn(demo.geometry, t_e, s_e,
                              lambda f, p_self=p_self: speech_estimators(demo, rates(f), [p_tone, p_self]), FS,
                              device=dev)
        e = monte_carlo_sweep(trial, ROBUST_SNRS, num_sims, seed + 1, SPEECH_BATCH, draws=robust_draws)["errors"]
        robustness[name] = {"snr_db": ROBUST_SNRS, **{
            f"{col}_mae_deg": [float(np.degrees(m)) for m in e[:, :, k].mean(axis=1)]
            for k, col in enumerate(("reference_peak", "matched_tone_cal", "matched_self_cal"))}}
    return {"beam_profiles": beam, "speech_mc": mc, "calibration_robustness": robustness}


def figures(sm: dict, bipolar: bool) -> None:
    """With ``HM2024_FIG_DIR`` set: each estimator's MAE against the SNR
    (``sm``: :func:`~.common.summarize` of each of :func:`run`'s sweeps)."""
    fig_mae_vs_snr({k: (v["snr_db"], v["mae_deg"]) for k, v in sm.items() if "mae_deg" in v},
                   f"target_xylo_{'bipolar' if bipolar else 'unipolar'}_mae.pdf")


def speech_figures(res: dict, bipolar: bool) -> None:
    """With ``HM2024_FIG_DIR`` set: the speech MC's three MAE curves and
    stage A's normalized rate profiles (JAX's two speech figures)."""
    mc = res["speech_mc"]
    fig_mae_vs_snr({lab: (mc["snr_db"], mc[lab]["mae_deg"]) for lab in SPEECH_LABELS},
                   f"target_xylo_speech_{'bipolar' if bipolar else 'unipolar'}_mae.pdf")
    grid = np.linspace(-180, 180, len(next(iter(res["beam_profiles"].values()))["profile"]))
    fig_lines(grid, {k: v["profile"] for k, v in res["beam_profiles"].items()}, "xylo_fixed_speech_beam.pdf",
              xlabel="DoA (deg.)", ylabel="normalized rate")


def main_speech(bipolar: bool, sims: int, num_grid: int, duration: float, device) -> dict:
    res = run_speech(bipolar=bipolar, num_sims=sims, num_grid=num_grid, duration=duration, device=device)
    speech_figures(res, bipolar)
    out = {
        "experiment": f"target_xylo_speech_{'bipolar' if bipolar else 'unipolar'}",
        "results": {
            "beam_profiles": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                              for k, v in res["beam_profiles"].items()},
            "speech_mc": res["speech_mc"],
            "calibration_robustness": res["calibration_robustness"],
        },
    }
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speech", action="store_true", help="the speech-target harness (run_speech)")
    ap.add_argument("--unipolar", action="store_true")
    ap.add_argument("--quick", action="store_true", help="10 trials a SNR")
    ap.add_argument("--sims", type=int, help="trials a SNR (default 100 bipolar, 20 unipolar)")
    ap.add_argument("--grid", type=int, default=16 * 7)
    ap.add_argument("--duration", type=float, help="template and frame length, s (default 0.25, speech 1.0)")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    bipolar = not args.unipolar
    sims = args.sims or (10 if args.quick else 100 if bipolar else 20)
    if args.speech:
        return main_speech(bipolar, sims, args.grid, args.duration or 1.0, args.device)
    res = run(bipolar=bipolar, num_sims=sims, num_grid=args.grid, duration=args.duration or 0.25, device=args.device)
    env = res.pop("reference_estimator_convention_envelope")
    sm = {k: summarize(v) for k, v in res.items()}
    figures(sm, bipolar)
    sm["reference_estimator_convention_envelope"] = env
    out = {"experiment": f"target_xylo_{'bipolar' if bipolar else 'unipolar'}_localization", "results": sm}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
