"""Wire-rate resampling for the serving path: 4x fewer samples on the wire
(counterpart of ``haghighatshoarmuir2024_tpu/ops/resample.py``).

The localization bands live at 1.6-2.6 kHz while the pipeline samples at
48 kHz, so a client may ship audio at fs/4 (12 kHz) and the server rebuilds
the 48 kHz stream on the device with a carried-state polyphase FIR.  The
host-side designs (:func:`design_upsample_fir`, :func:`decimate_fir`,
:func:`upsample_poly`, :func:`phase_table`) are numpy copies of the JAX
module's; :func:`upsample_poly_stream` is the device form in PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from .fir import full_fp32

UPSAMPLE_FACTOR = 4
TAPS_PER_PHASE = 16


def design_upsample_fir(
    factor: int = UPSAMPLE_FACTOR,
    taps_per_phase: int = TAPS_PER_PHASE,
    cutoff_frac: float = 0.09375,  # 4.5 kHz at fs=48k: band edge 2.6k in passband
    beta: float = 8.0,
) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, length factor*taps_per_phase, gain
    `factor` in the passband (compensates the zero-stuffing power loss).

    Default: 64 taps at the 48 kHz rate, cutoff 4.5 kHz, beta 8 (~80 dB
    stopband starting ~6.4 kHz) — images of the 1.6-2.6 kHz content land at
    >= 9.4 kHz, deep in the stopband.
    """
    L = factor * taps_per_phase
    n = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
    h = 2.0 * cutoff_frac * np.sinc(2.0 * cutoff_frac * n)
    h *= np.kaiser(L, beta)
    # unit DC gain for the unstuffed stream, then x`factor` for zero-stuffing
    h *= factor / np.sum(h)
    return h.astype(np.float32)


def decimate_fir(x: np.ndarray, factor: int = UPSAMPLE_FACTOR,
                 h: np.ndarray | None = None) -> np.ndarray:
    """Host-side (client) anti-aliased decimation along axis 0.

    Uses the same Kaiser prototype as the interpolator (without its x4
    gain): stopband from ~6.4 kHz keeps folded components out of the
    1.6-2.6 kHz band.  Causal alignment (output m taps history before it),
    matching `upsample_poly` on the other end — the round trip is a pure
    (L-1)-sample group delay at 48 kHz, identical on every mic, which the
    DoA path cannot see (it only uses inter-mic delays).
    """
    if h is None:
        h = design_upsample_fir(factor) / np.float32(factor)
    x = np.asarray(x, np.float32)
    flat = x.reshape(x.shape[0], -1)
    out = np.empty((x.shape[0], flat.shape[1]), np.float32)
    for c in range(flat.shape[1]):
        out[:, c] = np.convolve(flat[:, c], np.asarray(h, np.float32))[: x.shape[0]]
    return out.reshape(x.shape)[::factor].astype(np.float32)


def upsample_poly(x_wire: np.ndarray, h: np.ndarray,
                  factor: int = UPSAMPLE_FACTOR) -> np.ndarray:
    """Offline polyphase interpolation reference (host, numpy): zero-stuff
    by `factor`, causal FIR `h`, length factor*T_wire out.  Golden for the
    streaming device form."""
    x = np.asarray(x_wire, np.float32)
    T = x.shape[0]
    z = np.zeros((T * factor,) + x.shape[1:], np.float32)
    z[::factor] = x
    flat = z.reshape(z.shape[0], -1)
    out = np.empty_like(flat)
    for c in range(flat.shape[1]):
        out[:, c] = np.convolve(flat[:, c], h.astype(np.float32))[: z.shape[0]]
    return out.reshape(z.shape)


def upsample_poly_stream(x_wire: torch.Tensor, carry: torch.Tensor, h_phases,
                         factor: int = UPSAMPLE_FACTOR):
    """Streaming polyphase interpolation on the device (JAX
    ``upsample_poly_stream``, ``resample.py:91-129``).

    Args:
      x_wire:   (B, Tw, M) float32 wire-rate chunk.
      carry:    (B, K, M) float32, K = taps_per_phase - 1 previous wire
                samples (zeros at stream start).
      h_phases: (factor, taps_per_phase) phase table, ``h_phases[p, k] =
                h[factor*k + p]`` (:func:`phase_table`): numpy, or a float32
                tensor already on ``x_wire``'s device (no upload per call).
    Returns:
      (y, new_carry): y (B, factor*Tw, M) 48 kHz chunk equal to the offline
      :func:`upsample_poly` of the concatenated stream; new_carry (B, K, M).

    ``y[b, factor*i + p, m] = sum_k h[factor*k + p] * x[b, i - k, m]`` is a
    VALID correlation of the extended chunk with the reversed phase kernels:
    one grouped ``conv1d``, mics as groups, phases as output channels.
    cuDNN's TF32 is turned off (``full_fp32``), as the JAX form runs at
    ``Precision.HIGHEST``.
    """
    full_fp32()
    hp = torch.as_tensor(h_phases, dtype=torch.float32, device=x_wire.device)
    P, Kp = hp.shape
    B, Tw, M = x_wire.shape
    K = Kp - 1
    x_ext = torch.cat([carry, x_wire], dim=1)  # (B, K+Tw, M)
    weight = hp.flip(-1).repeat(M, 1)[:, None, :]  # (M*P, 1, Kp): mic g owns rows g*P..g*P+P-1
    out = torch.nn.functional.conv1d(x_ext.transpose(1, 2), weight, groups=M)  # (B, M*P, Tw)
    y = out.reshape(B, M, P, Tw).permute(0, 3, 2, 1).reshape(B, Tw * P, M)
    return y, x_ext[:, x_ext.shape[1] - K:]


def phase_table(h: np.ndarray, factor: int = UPSAMPLE_FACTOR) -> np.ndarray:
    """(factor, taps_per_phase) polyphase decomposition of `h` (numpy)."""
    h = np.asarray(h, np.float32)
    if h.size % factor:
        raise ValueError(f"{h.size} taps do not split into {factor} phases")
    return h.reshape(-1, factor).T.copy()
