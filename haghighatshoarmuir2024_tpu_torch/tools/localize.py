"""Offline file localization CLI (counterpart of
``haghighatshoarmuir2024_tpu/tools/localize.py``).

Feed a multi-channel wav/flac (or a mono file plus ``--simulate-doa`` to
propagate it through a synthetic array) and get one DoA estimate per frame
as JSON lines, computed on ``--device`` (the card by default)::

    python -m haghighatshoarmuir2024_tpu_torch.tools.localize recording.wav \\
        --model xylo --band 1600 1900 --frame 0.25

Models: ``xylo`` (the quantized SNN pipeline, the matched estimator after
calibration: kernels K1, K2 and K3 per frame), ``hilbert`` (the Hilbert
beamformer), ``music`` (the Bartlett scan; the noise-subspace
pseudospectrum under ``--sources K``), ``srp`` (SRP-PHAT).  ``--track``
adds an alpha-beta track of the estimates; ``--sources K`` tracks up to K
simultaneous sources from each frame's top-K profile peaks.  Invalid
combinations exit with code 2, as the JAX tool's do.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _build_estimator(model, geometry, bands, doa_list, frame, fs, device, calibrate=True, stacked=False,
                     auto=False, num_sources=1):
    """Per-frame estimator ``est(x) -> (doa, profile)``: the DoA and the
    angular profile it came from (rate / power / pseudospectrum, a tensor on
    ``device``), which feeds the multi-source peak picker (JAX
    ``localize.py:28-108``)."""
    band = bands[0]
    if model == "xylo":
        from ..models.xylo import Demo

        demo = Demo(geometry=geometry, freq_bands=[list(b) for b in bands], doa_list=doa_list,
                    recording_duration=frame, kernel_duration=10e-3, bipolar_spikes=True, fs=fs,
                    enforce_hw_limits=len(bands) == 1, device=device)
        method = "peak"
        if calibrate:
            if stacked or auto:
                demo.calibrate_profiles(band_stacked=True)
                method = "matched_auto" if auto else "matched_stacked"
            else:
                demo.calibrate_profiles()
                method = "matched"

        def est(x):
            doa, rate = demo.forward_batch(torch.as_tensor(x, device=device)[None], method=method)
            return float(doa[0]), rate[0].to(torch.float64)

        return est
    if model == "hilbert":
        from ..models.beamformer import Beamformer

        bf = Beamformer(geometry, kernel_duration=10e-3, freq_range=list(band), fs=fs, device=device)
        t = np.arange(0, frame, 1 / fs)
        bf_mat = bf.design_from_template((t, np.sin(2 * np.pi * float(np.mean(band)) * t)), doa_list)[0]

        def est(x):
            power = (bf.apply_to_signal(bf_mat, x).abs() ** 2).mean(dim=0)
            return float(doa_list[int(power.argmax())]), power

        return est
    if model == "music":
        from ..models.music import MUSIC

        music = MUSIC(geometry, freq_range=list(band), doa_list=doa_list, frame_duration=frame, fs=fs,
                      device=device)
        # the Bartlett scan for one source; the noise-subspace pseudospectrum
        # when hunting several
        ns = num_sources if num_sources > 1 else 0

        def est(x):
            p = music.beamforming(x, 2, 2048, num_sources=ns)
            return float(doa_list[int(p.argmax())]), p

        return est
    if model == "srp":
        from ..models.srp_phat import SRPPHAT

        srp = SRPPHAT(geometry, freq_range=list(band), doa_list=doa_list, fs=fs, frame_duration=frame,
                      device=device)

        def est(x):
            p = srp.apply_to_signal(x)
            return float(doa_list[int(p.argmax())]), p

        return est
    raise ValueError(f"unknown model {model!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="haghighatshoarmuir2024_tpu_torch.tools.localize",
                                description="Offline DoA localization of an audio file.")
    p.add_argument("audio", help="wav/flac path (multi-channel, or mono with --simulate-doa)")
    p.add_argument("--model", default="xylo", choices=["xylo", "hilbert", "music", "srp"])
    p.add_argument("--band", nargs=2, type=float, action="append", default=None, metavar=("F_LO", "F_HI"),
                   help="frequency band (Hz); repeat for a multi-band deployment (xylo only; default 1600 1900)")
    p.add_argument("--stacked", action="store_true",
                   help="xylo multi-band: band-stacked matched estimator instead of the folded profile")
    p.add_argument("--auto", action="store_true",
                   help="xylo multi-band: SNR-adaptive blend of the folded and per-band cosine scores")
    p.add_argument("--grid", type=int, default=225)
    p.add_argument("--frame", type=float, default=0.25)
    p.add_argument("--fs", type=float, default=48_000.0)
    p.add_argument("--radius", type=float, default=4.5e-2)
    p.add_argument("--num-mic", type=int, default=7)
    p.add_argument("--simulate-doa", type=float, default=None,
                   help="mono input: propagate through a synthetic array at this DoA (radians)")
    p.add_argument("--snr-db", type=float, default=None, help="with --simulate-doa: add white noise at this SNR")
    p.add_argument("--no-calibrate", action="store_true",
                   help="xylo: reference-parity peak estimator instead of the calibrated matched estimator")
    p.add_argument("--track", action="store_true",
                   help="wrapped-angle alpha-beta tracking of the per-frame estimates: adds doa_tracked_* fields")
    p.add_argument("--sources", type=int, default=1, metavar="K",
                   help="track up to K simultaneous sources from the per-frame top-K peaks of the angular "
                        "profile (gated GNN tracker); adds a 'sources' field with the confirmed tracks")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default="cuda", help="where the estimators compute (default: the card)")
    args = p.parse_args(argv)

    from ..geometry import CenterCircularArray, resolve_device
    from ..io.audio import FileAudioSource

    device = resolve_device(args.device)
    geometry = CenterCircularArray(radius=args.radius, num_mic=args.num_mic)
    doa_list = np.linspace(-np.pi, np.pi, args.grid)
    src = FileAudioSource(args.audio, fs=args.fs)

    bands = args.band if args.band else [[1600.0, 1900.0]]
    if len(bands) > 1 and args.model != "xylo":
        print("multiple --band only supported with --model xylo", file=sys.stderr)
        return 2
    if (args.stacked or args.auto) and (len(bands) < 2 or args.no_calibrate):
        print("--stacked/--auto need >= 2 --band and calibration", file=sys.stderr)
        return 2
    if args.sources < 1:
        print("--sources must be >= 1", file=sys.stderr)
        return 2
    est = _build_estimator(args.model, geometry, bands, doa_list, args.frame, args.fs, device,
                           calibrate=not args.no_calibrate, stacked=args.stacked, auto=args.auto,
                           num_sources=args.sources)

    rng = np.random.default_rng(0)
    tracker = None
    if args.track:
        from ..utils.tracking import DoaTracker

        tracker = DoaTracker()
    multi = None
    if args.sources > 1:
        from ..ops.peaks import top_k_peaks
        from ..utils.tracking import MultiDoaTracker

        multi = MultiDoaTracker(num_tracks=args.sources + 2, max_misses=4)
    results = []
    for i, chunk in enumerate(src.frames(args.frame)):
        if args.max_frames is not None and i >= args.max_frames:
            break
        if args.simulate_doa is not None:
            if chunk.shape[1] != 1:
                print("--simulate-doa needs a mono file", file=sys.stderr)
                return 2
            from ..ops.interp import signal_from_template

            t = torch.arange(chunk.shape[0], dtype=torch.float64) / args.fs
            # MUSIC's and SRP's physical steering matches the t - delay
            # synthesis convention (ops/interp.signal_from_template)
            sign = -1 if args.model in ("music", "srp") else 1
            x = signal_from_template(geometry, t, torch.as_tensor(chunk[:, 0]), args.simulate_doa, fs=args.fs,
                                     delay_sign=sign).numpy()
            if args.snr_db is not None:
                sigma = np.sqrt((x**2).mean() / 10 ** (args.snr_db / 10))
                x = x + sigma * rng.standard_normal(x.shape)
        else:
            if chunk.shape[1] < args.num_mic:
                print(f"file has {chunk.shape[1]} channels, need {args.num_mic} (or use --simulate-doa)",
                      file=sys.stderr)
                return 2
            x = chunk[:, : args.num_mic]
        doa, prof = est(x.astype(np.float32))
        rec = {"frame": i, "t_sec": round(i * args.frame, 3), "doa_rad": round(doa, 4),
               "doa_deg": round(float(np.rad2deg(doa)), 2)}
        if tracker is not None:
            trk = tracker.update(doa)
            rec["doa_tracked_rad"] = round(trk, 4)
            rec["doa_tracked_deg"] = round(float(np.rad2deg(trk)), 2)
        if multi is not None:
            idx, _, ok = top_k_peaks(prof, args.sources, distance=max(args.grid // 32, 2), rel_height=0.2)
            thetas, confirmed = multi.update(doa_list[idx.cpu().numpy()], ok.cpu().numpy())
            rec["sources"] = [{"track": int(m), "doa_rad": round(float(thetas[m]), 4),
                               "doa_deg": round(float(np.rad2deg(thetas[m])), 2)}
                              for m in np.nonzero(confirmed)[0]]
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if results:
        doas = np.array([r["doa_rad"] for r in results])
        med = float(np.angle(np.mean(np.exp(1j * doas))))
        print(json.dumps({"frames": len(results), "doa_circmean_deg": round(np.rad2deg(med), 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
