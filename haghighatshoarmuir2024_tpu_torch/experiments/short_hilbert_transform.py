"""STHT quality analysis, the port's twin of
``experiments/short_hilbert_transform.py`` (reference:
paper_plots/short_hilbert_transform.py and the checks of its
tests/hilbert_snn.py:242-326):

- the in-band magnitude error of the STHT kernel's frequency response
  (numpy, on the host);
- the STHT analytic signal of a 2 kHz tone (``ops/stht.stht``, on the
  device) against scipy's full-signal Hilbert transform;
- the RZCC spike timing of a tone (``ops/spikes.rzcc_encode``): the +1
  spikes sit at the tone's downward zero crossings.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.short_hilbert_transform [--device cpu]

Prints one JSON object with the JAX twin's keys; with ``HM2024_FIG_DIR``
set, also writes JAX's two figures there (``short_hilbert_transform.pdf``,
``rzcc_plots.pdf``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry import resolve_device
from ..ops.spikes import rzcc_encode
from ..ops.stht import stht, stht_kernel
from .common import FS, _fig_dir, _plt, arg_parser, maybe_savefig

DURATIONS = (5e-3, 10e-3, 20e-3)


def kernel_frequency_response(kernel_duration: float) -> dict:
    """The STHT kernel's in-band (1-4 kHz) deviation from the ideal Hilbert
    magnitude |H(f)| = 1."""
    H = np.fft.rfft(stht_kernel(int(FS * kernel_duration)), 1 << 16)
    freqs = np.fft.rfftfreq(1 << 16, 1 / FS)
    mag_err = np.abs(np.abs(H[(freqs >= 1000) & (freqs <= 4000)]) - 1.0)
    return {"mag_err_max_inband": float(mag_err.max()), "mag_err_mean_inband": float(mag_err.mean())}


def stht_vs_full_hilbert(kernel_duration: float, dev, freq: float = 2000.0) -> dict:
    """The STHT analytic signal of a 0.25 s tone against scipy's
    ``hilbert`` of the whole signal, over the steady interior (2K samples
    from either end; the STHT's group delay is K/2): the error relative to
    the mean magnitude."""
    from scipy.signal import hilbert

    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * freq * t)
    ker = stht_kernel(int(FS * kernel_duration))
    inphase, quad = stht(torch.as_tensor(sig[:, None], dtype=torch.float32, device=dev), ker)
    a_stht = torch.complex(inphase, quad)[:, 0].cpu().numpy()
    a_full = hilbert(sig)
    K = len(ker)
    sl = slice(2 * K, len(t) - 2 * K)
    err = np.abs(a_stht[sl] - a_full[sl]) / np.abs(a_full[sl]).mean()
    return {"rel_err_mean": float(err.mean()), "rel_err_max": float(err.max())}


def rzcc_spike_timing(dev, freq: float = 2000.0) -> dict:
    """The bipolar RZCC raster of a 50 ms tone: the +1 spikes (peaks of the
    cumsum) fall at the downward zero crossings of the sine, phase ≈ 0.5 of
    a period; their count and the phase's mean and spread past the first
    two."""
    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * freq * t)
    rw = int(FS / freq) // 2
    x = torch.as_tensor(sig[:, None], dtype=torch.float32, device=dev)
    spikes = rzcc_encode(x, rw, bipolar=True)[:, 0].cpu().numpy()
    pos = np.nonzero(spikes == 1)[0]
    # paper_plots/rzcc_plots.py: the tone with its bipolar RZCC spike train
    # (stems at the zero crossings)
    if _fig_dir():
        plt = _plt()
        fig, ax = plt.subplots(figsize=(7, 3))
        n = int(FS / freq * 8)  # ~8 periods
        ax.plot(t[:n] * 1e3, sig[:n], lw=1, label=f"{freq:.0f} Hz tone")
        neg = np.nonzero(spikes == -1)[0]
        for idx, linefmt, markerfmt, lbl in ((pos, "g-", "g^", "+1 spikes"), (neg, "r-", "rv", "-1 spikes")):
            sel = idx[idx < n]
            ax.stem(t[sel] * 1e3, spikes[sel] * 0.9, linefmt=linefmt, markerfmt=markerfmt, basefmt=" ", label=lbl)
        ax.set_xlabel("t [ms]")
        ax.legend(loc="upper right", fontsize=8)
        maybe_savefig(fig, "rzcc_plots.pdf")
        plt.close(fig)
    phases = (t[pos] * freq) % 1.0
    return {"num_pos_spikes": int(len(pos)), "phase_mean": float(phases[2:].mean()),
            "phase_std": float(phases[2:].std())}


def run(device=None) -> dict:
    dev = resolve_device(device)
    return {
        "kernel_response": {f"{int(d * 1e3)}ms": kernel_frequency_response(d) for d in DURATIONS},
        "stht_vs_hilbert": {f"{int(d * 1e3)}ms": stht_vs_full_hilbert(d, dev) for d in DURATIONS},
        "rzcc_timing": rzcc_spike_timing(dev),
    }


def kernel_response_figure() -> None:
    """With ``HM2024_FIG_DIR`` set: |H(f)| of the STHT kernel of each
    duration against the ideal Hilbert response
    (paper_plots/short_hilbert_transform.py)."""
    if not _fig_dir():
        return
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    freqs = np.fft.rfftfreq(1 << 16, 1 / FS)
    for d in DURATIONS:
        H = np.fft.rfft(stht_kernel(int(FS * d)), 1 << 16)
        ax.plot(freqs / 1e3, np.abs(H), lw=1, label=f"{d*1e3:.0f} ms kernel")
    ax.axhline(1.0, color="k", ls="--", lw=0.8, label="ideal Hilbert")
    ax.set_xlim(0, 10)
    ax.set_xlabel("frequency [kHz]")
    ax.set_ylabel("|H(f)|")
    ax.legend(fontsize=8)
    maybe_savefig(fig, "short_hilbert_transform.pdf")
    plt.close(fig)


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    kernel_response_figure()
    out = run(args.device)
    print(json.dumps({"experiment": "short_hilbert_transform", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
