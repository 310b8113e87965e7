"""Plain reference of the quantized SNN localizer (Haghighatshoar & Muir 2024,
arXiv:2402.11748; the reference implementation synsense/HaghighatshoarMuir2024,
micloc/xylo_snn_localization.py), written from the method, not from the port.

It imports neither JAX nor the package under test.  Everything the program
derives from the design inputs is worked out again here: the quantized
integers from the float design matrices, the encode, the RZCC spikes, the
integer LIF counts, the rates and the matched scores.

Precision: the encode runs in ``dtype`` (float64 for the reference; float32
with the FIR's operands rounded to TF32 for the control, the nearest
precision below the configuration's float32 with TF32 off).  The spikes come
from scipy's ``find_peaks``; the LIF is exact integer arithmetic; the scores
are float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal
import torch

STATE_MIN, STATE_MAX = -(2**15), 2**15 - 1


def fp32_exact() -> None:
    """Float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even:
    what a TF32 product does to its operands before it multiplies them."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass
class Model:
    """A configuration's quantities as the method defines them."""

    fs: float
    bands: np.ndarray  # (F, 2) Hz
    grid: np.ndarray  # (G,) DoA grid, radians
    kernel: np.ndarray  # (K,) STHT FIR taps
    ba: list  # per band (b, a) of the order-1 Butterworth bandpass
    rw: int  # RZCC robust width (the suppression distance)
    w_in: np.ndarray  # (2C, N) int64: [W; -W] quantized
    dash_syn: np.ndarray  # (N,)
    dash_mem: np.ndarray  # (N,)
    threshold: np.ndarray  # (N,)
    rec_coef: int  # the uniform recurrence c of w_rec = c·ones
    profiles: np.ndarray  # (G, G) matched profiles, mean-removed, unit norm

    @property
    def channels(self) -> int:
        return self.w_in.shape[0] // 2

    @property
    def neurons(self) -> int:
        return self.w_in.shape[1]


def stht_kernel(n: int) -> np.ndarray:
    """The FIR Hilbert kernel of length n: ``fftshift(imag(hilbert(impulse)))``
    (micloc/beamformer.py:48-52)."""
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[0] = 1
        h[1:(n + 1) // 2] = 2
    return np.fft.fftshift(np.imag(np.fft.ifft(h.astype(complex))))


def quantize(bf_mats, bands, fs: float, target_dt: float = 1e-3):
    """The two-layer network of the method (block-diagonal input weights per
    band, ``[W; -W]`` for the two spike polarities, the uniform recurrence
    -0.1/N, an all-ones readout) under one global int8 scale, and each
    band's tau 1/(2π f_mid) as a bit-shift decay at the core clock
    (micloc/xylo_snn_localization.py:173-284)."""
    bf = [np.asarray(m, np.float64) for m in bf_mats]
    c_in, g = bf[0].shape
    F = len(bf)
    W = np.zeros((F * c_in, F * g))
    for i, m in enumerate(bf):
        W[i * c_in:(i + 1) * c_in, i * g:(i + 1) * g] = m
    W = np.vstack([W, -W])
    N = F * g
    rec = -0.1 / N
    scale = 127.0 / max(np.abs(W).max(), abs(rec), 1.0)  # the readout's ones take part in the scale
    if scale > 32767.0:  # the threshold 1.0 must fit 16 bits
        scale = 32767.0
    q = lambda v: np.round(np.asarray(v, np.float64) * scale).astype(np.int64)  # noqa: E731
    tau_over_dt = np.array([fs / (2 * np.pi * float(np.mean(b))) for b in bands for _ in range(g)])
    dash = np.clip(np.round(np.log2(np.maximum(tau_over_dt, 1.0))), 0, 15).astype(np.int64)
    threshold = np.full(N, max(int(q(1.0)), 1), np.int64)
    return q(W), dash, dash.copy(), threshold, int(q(rec))


def build(cfg: dict, arrays: dict) -> Model:
    """The reference's model from a configuration file's ``model`` block and
    its design inputs (``bf_i``, ``profiles``)."""
    m = cfg["model"]
    fs = float(m["fs"])
    bands = np.asarray(m["freq_bands"], np.float64)
    bf = [arrays[f"bf_{i}"] for i in range(len(bands))]
    w_in, ds, dm, th, rec = quantize(bf, bands, fs)
    ba = [tuple(np.asarray(v, np.float64) for v in scipy.signal.butter(1, list(b), btype="bandpass", fs=fs))
          for b in bands]
    return Model(fs=fs, bands=bands, grid=np.linspace(-np.pi, np.pi, int(m["grid_points"])),
                 kernel=stht_kernel(int(round(fs * float(m["kernel_duration_s"])))), ba=ba,
                 rw=int(fs / bands[0][1]) // 2, w_in=w_in, dash_syn=ds, dash_mem=dm, threshold=th, rec_coef=rec,
                 profiles=np.asarray(arrays["profiles"], np.float64))


# ------------------------------------------------------------------ encode
def _fir(x: torch.Tensor, taps: np.ndarray, tf32: bool) -> torch.Tensor:
    """Causal FIR along the last axis of (R, T) ``x`` with zero history, a
    direct sum of products in ``x``'s dtype."""
    h = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    if tf32:
        x, h = to_tf32(x), to_tf32(h)
    K = h.shape[0]
    xp = torch.nn.functional.pad(x[:, None, :], (K - 1, 0))
    return torch.nn.functional.conv1d(xp, h.flip(0).reshape(1, 1, K))[:, 0, :]


def encode(model: Model, x: torch.Tensor, dtype=torch.float64, tf32: bool = False, stream: bool = False):
    """(B, T, M) audio → the integrated bandpassed analytic stack (B, T, C)
    as a numpy array in ``dtype``: the in-phase part delayed by K/2 samples
    (a wrap-around roll offline, as the method's ``np.roll``; a delay line
    from silence for a stream), the quadrature part the causal Hilbert FIR,
    then each band's bandpass from rest and the running sum."""
    fp32_exact()
    B, T, M = x.shape
    K = len(model.kernel)
    xr = x.to(dtype).permute(0, 2, 1).reshape(B * M, T)
    quad = _fir(xr, model.kernel, tf32)
    if stream:
        inphase = torch.nn.functional.pad(xr, (K // 2, 0))[:, :T]
    else:
        inphase = torch.roll(xr, K // 2, dims=1)
    stack = torch.cat([inphase.reshape(B, M, T), quad.reshape(B, M, T)], dim=1).cpu().numpy()  # (B, 2M, T)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    out = []
    for b, a in model.ba:
        y = scipy.signal.lfilter(b.astype(np_dtype), a.astype(np_dtype), stack, axis=-1).astype(np_dtype)
        out.append(np.cumsum(y, axis=-1, dtype=np_dtype))
    return np.concatenate(out, axis=1).transpose(0, 2, 1)  # (B, T, C), band-major channels


# -------------------------------------------------------------------- RZCC
def rzcc(cs: np.ndarray, rw: int):
    """(B, T, C) integrated signal → the bipolar spike masks (B, T, C):
    the peaks and the valleys of each channel at least ``rw`` samples apart,
    the higher first (scipy ``find_peaks(distance=rw)``)."""
    B, T, C = cs.shape
    kp = np.zeros((B, C, T), bool)
    kn = np.zeros((B, C, T), bool)
    rows = np.ascontiguousarray(cs.transpose(0, 2, 1))
    for b in range(B):
        for c in range(C):
            v = rows[b, c]
            kp[b, c, scipy.signal.find_peaks(v, distance=rw)[0]] = True
            kn[b, c, scipy.signal.find_peaks(-v, distance=rw)[0]] = True
    return kp.transpose(0, 2, 1), kn.transpose(0, 2, 1)


def set_bits(kp: np.ndarray, kn: np.ndarray) -> int:
    """Input spikes of the bipolar raster ``[kp & ~kn, kn]``."""
    return int((kp & ~kn).sum() + kn.sum())


# --------------------------------------------------------------------- LIF
def lif_counts(model: Model, kp: np.ndarray, kn: np.ndarray, device, checkpoints=None, block: int = 250):
    """Integer LIF spike counts (B, N) of the bipolar raster
    ``[kp & ~kn, kn]`` (B, T, C) from rest, one step at a time:

        isyn ← sat(isyn − (isyn >> dash_syn) + w_in·s + c·Σspk)
        vmem ← sat(vmem − (vmem >> dash_mem) + isyn)
        spk  ← vmem ≥ threshold;  vmem ← vmem − spk·threshold

    ``sat`` the 16-bit range.  ``checkpoints`` (step counts) also returns the
    counts after each of them, as a list."""
    fp32_exact()
    B, T, C = kp.shape
    raster = np.concatenate([kp & ~kn, kn], axis=-1)
    w = torch.as_tensor(model.w_in, dtype=torch.float32, device=device)  # products exact below 2^24
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)  # noqa: E731
    ds, dm, th = i32(model.dash_syn), i32(model.dash_mem), i32(model.threshold)
    N = model.neurons
    isyn, vmem, spk, counts = (torch.zeros((B, N), dtype=torch.int32, device=device) for _ in range(4))
    marks = sorted(set(checkpoints or []))
    saved = []
    for t0 in range(0, T, block):
        s = torch.as_tensor(raster[:, t0:t0 + block], dtype=torch.float32, device=device)
        cur_blk = torch.matmul(s, w).to(torch.int32).transpose(0, 1).contiguous()  # (blk, B, N)
        for i in range(cur_blk.shape[0]):
            cur = cur_blk[i]
            if model.rec_coef:
                cur = cur + model.rec_coef * spk.sum(dim=-1, keepdim=True, dtype=torch.int32)
            isyn = torch.clamp(isyn - (isyn >> ds) + cur, STATE_MIN, STATE_MAX)
            vmem = torch.clamp(vmem - (vmem >> dm) + isyn, STATE_MIN, STATE_MAX)
            spk = (vmem >= th).to(torch.int32)
            vmem = vmem - spk * th
            counts += spk
            if len(saved) < len(marks) and t0 + i + 1 == marks[len(saved)]:
                saved.append(counts.clone())
    return (counts, saved) if checkpoints is not None else counts


# ---------------------------------------------------------------- estimate
def scores(model: Model, rates: np.ndarray) -> np.ndarray:
    """(..., F·G) unfolded rates → (..., G) matched scores: the cosine of
    the band-averaged rate profile, mean removed, with each calibrated
    profile (float64).  A silent profile scores 0 everywhere."""
    G = len(model.grid)
    r = np.asarray(rates, np.float64).reshape(*np.shape(rates)[:-1], -1, G).mean(axis=-2)
    r = r - r.mean(axis=-1, keepdims=True)
    n = np.linalg.norm(r, axis=-1, keepdims=True)
    r = np.divide(r, n, out=np.zeros_like(r), where=n > 0)
    return r @ model.profiles.T


def folded(model: Model, rates: np.ndarray) -> np.ndarray:
    G = len(model.grid)
    return np.asarray(rates, np.float64).reshape(*np.shape(rates)[:-1], -1, G).mean(axis=-2)


def offline_rates(model: Model, x: torch.Tensor, device, dtype=torch.float64, tf32: bool = False, block: int = 96):
    """(B, T, M) frames → (unfolded rates (B, F·G), input set bits) of the
    reference (``dtype``/``tf32``: see :func:`encode`), encoded ``block``
    frames at a time."""
    masks = [rzcc(encode(model, x[i:i + block], dtype, tf32), model.rw) for i in range(0, x.shape[0], block)]
    kp = np.concatenate([m[0] for m in masks])
    kn = np.concatenate([m[1] for m in masks])
    counts = lif_counts(model, kp, kn, device)
    T = x.shape[1]
    return counts.cpu().numpy().astype(np.float64) / T * model.fs, set_bits(kp, kn)


def stream_counts(model: Model, chunks: torch.Tensor, steps: int, device, dtype=torch.float64, tf32: bool = False):
    """The carried counts (steps, S, N) of S streams after each of their
    first ``steps`` chunks, every stream sending ``chunks`` (S, Tc, M) once a
    period.  A stream's answer after a chunk covers what it could decide:
    the integrated signal, led by ``2·rw + 4·rw`` samples of rest, cut into
    windows of the last undecided ``6·rw`` samples and the new chunk, of
    which the ``Tc`` samples after the first ``2·rw`` are decided by their
    own window's peaks (the lookahead that RZCC needs at a chunk's end)."""
    S, Tc, M = chunks.shape
    audio = chunks.repeat(1, steps, 1)  # (S, steps·Tc, M): the same chunk every period
    cs = encode(model, audio, dtype, tf32, stream=True)
    guard, pending = 2 * model.rw, 4 * model.rw
    Z = np.concatenate([np.zeros((S, guard + pending, cs.shape[-1]), cs.dtype), cs], axis=1)
    kp = np.zeros((S, steps * Tc, cs.shape[-1]), bool)
    kn = np.zeros_like(kp)
    for j in range(steps):
        win = Z[:, j * Tc:j * Tc + guard + pending + Tc]
        p, n = rzcc(win, model.rw)
        kp[:, j * Tc:(j + 1) * Tc] = p[:, guard:guard + Tc]
        kn[:, j * Tc:(j + 1) * Tc] = n[:, guard:guard + Tc]
    _, saved = lif_counts(model, kp, kn, device, checkpoints=[(j + 1) * Tc for j in range(steps)])
    return torch.stack(saved).cpu().numpy(), set_bits(kp, kn)
