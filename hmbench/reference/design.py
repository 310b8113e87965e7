"""Plain design of a configuration's inputs: each band's beamforming matrix
and the matched profiles, written from the method (Haghighatshoar & Muir
2024, arXiv:2402.11748; micloc/snn_beamformer.py:82-211 and
micloc/xylo_snn_localization.py:115-145), in float64 NumPy and SciPy.

    python3 -m hmbench.reference.design --config threeband_48k

writes ``hmbench/configs/<config>.npz``, which the program (through its
design cache) and the reference both read.  Like the rest of
``hmbench/reference/`` it imports nothing of the program.

A band's design, per DoA of the grid: the band-centre tone over one frame,
delayed to each microphone → the STHT's in-phase (a wrap-around roll by
K/2) and quadrature (the causal Hilbert FIR) parts stacked → the order-2
Butterworth bandpass → bipolar RZCC spikes of each channel's running sum →
the LIF filter → the covariance of the last three quarters, folded into the
M × M complex Hermitian form → its top eigenvector as the real 2M-vector
[Re u; Im u].  An eigenvector is defined up to a unit phase, and the
quantized weights follow it: freezing the floats fixes it for both sides.

The profiles: row g is the reference's folded rate profile of a noiseless
source (the calibration template) at grid DoA g, mean removed, unit norm.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import scipy.signal
import torch

from . import localizer as ref

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def array_rt(spec: dict):
    """Radii and angles of a ``center_circular`` array: ``num_mic − 1``
    microphones on the circle from angle 0 to 2π inclusive (the reference's
    duplicated first microphone), the last at the centre."""
    if spec["kind"] != "center_circular":
        raise ValueError(f"unknown array kind {spec['kind']!r}")
    n = int(spec["num_mic"])
    r = np.r_[np.full(n - 1, float(spec["radius_m"])), 0.0]
    theta = np.r_[np.linspace(0, 2 * np.pi, n - 1), 0.0]
    return r, theta


def delays(spec: dict, doa: np.ndarray) -> np.ndarray:
    """(G,) directions → (G, M) plane-wave delays in seconds."""
    r, theta = array_rt(spec)
    return -r * np.cos(theta - np.asarray(doa, np.float64)[:, None]) / float(spec["speed_m_s"])


def lif_kernel(tau: float, fs: float, n: int, mass: float = 0.999) -> np.ndarray:
    """The LIF's normalized impulse response ``(t/τ)·exp(−t/τ)``, cut where
    its cumulative mass reaches ``mass``."""
    t = np.arange(n) / fs
    h = (t / tau) * np.exp(-t / tau)
    h = h / h.sum()
    return h[:int(np.sum(np.cumsum(h) < mass))]


def band_design(spec: dict, band, grid: np.ndarray, chunk: int = 32) -> np.ndarray:
    """The (2M, G) beamforming matrix of one band."""
    m = spec["model"]
    fs, frame = float(m["fs"]), float(m["frame_s"])
    lo, hi = (float(v) for v in band)
    t = np.arange(0, frame, 1 / fs)
    sig = np.sin(2 * np.pi * (lo + hi) / 2 * t)
    ts = np.arange(t.min(), t.max(), 1 / fs)  # the template on the array's clock
    sig = np.interp(ts, t, sig)
    T = len(ts)
    K = int(round(fs * float(m["kernel_duration_s"])))
    kern = ref.stht_kernel(K)
    b, a = scipy.signal.butter(2, [lo, hi], btype="bandpass", fs=fs)
    rw = int(fs / hi) // 2
    h = lif_kernel(1 / (2 * np.pi * (lo + hi) / 2), fs, T)
    d = delays(m["array"], grid)
    d = d - d.min(axis=1, keepdims=True)
    out = []
    for s in range(0, len(grid), chunk):
        tq = np.maximum(ts[None, :, None] - d[s:s + chunk, None, :], ts[0])  # (g, T, M)
        x = np.interp(tq, ts, sig)
        quad = scipy.signal.fftconvolve(x, kern[None, :, None], axes=1)[:, :T]
        y = scipy.signal.lfilter(b, a, np.concatenate([np.roll(x, K // 2, axis=1), quad], axis=2), axis=1)
        cs = np.cumsum(y, axis=1)
        spikes = np.zeros_like(cs)
        for g in range(cs.shape[0]):
            for c in range(cs.shape[2]):
                spikes[g, scipy.signal.find_peaks(cs[g, :, c], distance=rw)[0], c] = 1.0
                spikes[g, scipy.signal.find_peaks(-cs[g, :, c], distance=rw)[0], c] = -1.0
        v = scipy.signal.lfilter(h, [1.0], spikes, axis=1)[:, T // 4:]
        cov = np.einsum("gtm,gtn->gmn", v, v) / v.shape[1]
        M = cov.shape[-1] // 2
        folded = (cov[:, :M, :M] + cov[:, M:, M:]) / 2 + 1j * (cov[:, :M, M:] + cov[:, M:, :M].transpose(0, 2, 1)) / 2
        u = np.linalg.eigh(folded)[1][:, :, -1]
        out.append(np.concatenate([u.real, u.imag], axis=1))
    return np.concatenate(out).T


def jittered_tone(freq: float, n: int, fs: float, seed: int, eps: float = 0.01) -> np.ndarray:
    """A tone whose frequency jitters by ``eps`` sample to sample, drawn
    from ``seed`` (the live benchmark's jittered-sine template,
    paper_plots/snn_localization_benchmark.py:116-148)."""
    f = freq * (1 + eps * np.random.default_rng(seed).standard_normal(n))
    return np.sin(2 * np.pi * np.cumsum(f) / fs)


def calibration_signal(spec: dict, n: int) -> np.ndarray:
    """The calibration template of ``n`` samples: the first band's centre
    tone, or the configuration's jittered multi-band template."""
    m = spec["model"]
    fs = float(m["fs"])
    bands = np.asarray(m["freq_bands"], np.float64)
    if spec["calibration"] == "default":
        return np.sin(2 * np.pi * bands[0].mean() * np.arange(n) / fs)
    sig = sum(jittered_tone(b.mean(), n, fs, seed=int(spec["calibration"]["seed"])) for b in bands)
    return sig / np.abs(sig).max()


def profiles(spec: dict, bf: dict, device, rows=None, block: int = 32) -> np.ndarray:
    """The (G, G) matched profiles of the quantized reference for a noiseless
    calibration source at each grid DoA (``rows``: only those of these grid
    indices)."""
    m = spec["model"]
    fs = float(m["fs"])
    n = int(round(fs * float(m["frame_s"])))
    G = int(m["grid_points"])
    model = ref.build(spec, {**bf, "profiles": np.zeros((G, G))})
    t = np.arange(n) / fs
    sig = calibration_signal(spec, n)
    doa = model.grid if rows is None else model.grid[np.asarray(rows)]
    out = []
    for s in range(0, len(doa), block):
        tq = t[None, :, None] + delays(m["array"], doa[s:s + block])[:, None, :]
        x = torch.as_tensor(np.interp(tq, t, sig), dtype=torch.float32)
        rates, _ = ref.offline_rates(model, x, device)
        out.append(ref.folded(model, rates))
    p = np.concatenate(out)
    p = p - p.mean(axis=1, keepdims=True)
    return p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-12)


def design(spec: dict, device="cpu") -> dict:
    """The design inputs of a configuration file's contents: ``bf_i``
    (float32), ``profiles`` (float32) and, where the calibration has one,
    ``template`` (float64)."""
    m = spec["model"]
    grid = np.linspace(-np.pi, np.pi, int(m["grid_points"]))
    bf = {f"bf_{i}": band_design(spec, band, grid).astype(np.float32) for i, band in enumerate(m["freq_bands"])}
    out = {**bf, "profiles": profiles(spec, bf, device).astype(np.float32)}
    if spec["calibration"] != "default":
        out["template"] = calibration_signal(spec, int(round(float(m["fs"]) * float(m["frame_s"]))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    spec = json.loads((CONFIG_DIR / f"{args.config}.json").read_text())
    np.savez(CONFIG_DIR / spec["design_inputs"], **design(spec, torch.device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
