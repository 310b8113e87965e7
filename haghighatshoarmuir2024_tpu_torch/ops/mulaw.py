"""Mu-law wire codecs for the serving path: a numpy copy of
``haghighatshoarmuir2024_tpu/ops/mulaw.py`` (that module is numpy-only too,
but its package imports JAX).

The 8-bit codec is the continuous mu-law curve (mu = 255): bit 7 = sign
(0 positive), bits 0-6 = companded magnitude; decode on the device is one
256-entry table gather.  The 4-bit codec (mu = 15) packs two codes per byte
along time.  The reference streams raw float audio in-process
(micloc/record.py:54-60) and has no wire format.
"""
from __future__ import annotations

import numpy as np

MU = 255.0


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """Encode float audio in [-1, 1] (or int16 PCM) to mu-law uint8.

    Host-side (producer/client) op — plain numpy, no device involvement.
    """
    x = np.asarray(x)
    if x.dtype == np.int16:
        x = x.astype(np.float32) * (1.0 / 32768.0)
    else:
        x = np.clip(x.astype(np.float32), -1.0, 1.0)
    # Compand in float64 EXPLICITLY: under numpy>=2 (NEP 50) the python-float
    # MU no longer promotes the float32 input, and a float32 log1p here
    # drifts off the C encoder (native/streamc.cpp mulaw_code, all-double)
    # by ±1 code on ~2e-6 of samples — breaking the byte-identity contract.
    mag = np.log1p(MU * np.abs(x).astype(np.float64)) / np.log1p(MU)
    q = np.round(mag * 127.0).astype(np.uint8)
    return np.where(x >= 0, q, q + np.uint8(128)).astype(np.uint8)


def mulaw_decode_table() -> np.ndarray:
    """(256,) float32 decode table: ``table[code] == decoded value``.

    Device-side use: upload once and gather ``table[raw.long()]`` in the
    serving ingest (``runtime/server.py``).
    """
    idx = np.arange(256, dtype=np.float32)
    sgn = np.where(idx < 128, np.float32(1.0), np.float32(-1.0))
    mag = np.where(idx < 128, idx, idx - 128) / np.float32(127.0)
    return (sgn * (np.power(1.0 + MU, mag) - 1.0) / MU).astype(np.float32)


def mulaw_decode(code: np.ndarray) -> np.ndarray:
    """Host-side decode (tests / reference): uint8 -> float32 in [-1, 1]."""
    return mulaw_decode_table()[np.asarray(code, np.int64)]


# ---------------------------------------------------------------- 4-bit wire
# Half of u8 again: sign bit + 3 companded magnitude bits, two codes packed
# per byte along the time axis.  mu = 15 balances the 8 magnitude levels
# across the dynamic range (mu = 255 would spend most of them below -30 dBFS).
# Per-sample SQNR is ~14 dB broadband; after the serving pipeline's 1.6-2.6
# kHz bandpass only ~1/9 of that quantization noise power lands in band, so
# the effective in-band SNR is ~23 dB — comfortably above what the RZCC
# zero-crossing front end needs (accuracy gates in tests/test_server.py and
# experiments/serving_throughput.py hold at 1.00 @5 deg).
MU4 = 15.0


def mulaw4_encode(x: np.ndarray) -> np.ndarray:
    """Encode float audio in [-1, 1] (or int16 PCM) to 4-bit mu-law codes,
    returned UNPACKED as uint8 values in 0..15 (see :func:`pack4`)."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        x = x.astype(np.float32) * (1.0 / 32768.0)
    else:
        x = np.clip(x.astype(np.float32), -1.0, 1.0)
    # float64 companding for byte-identity with the C encoder (see
    # mulaw_encode above)
    mag = np.log1p(MU4 * np.abs(x).astype(np.float64)) / np.log1p(MU4)
    q = np.round(mag * 7.0).astype(np.uint8)
    return np.where(x >= 0, q, q + np.uint8(8)).astype(np.uint8)


def mulaw4_decode_table() -> np.ndarray:
    """(16,) float32 decode table (device side: one tiny gather)."""
    idx = np.arange(16, dtype=np.float32)
    sgn = np.where(idx < 8, np.float32(1.0), np.float32(-1.0))
    mag = np.where(idx < 8, idx, idx - 8) / np.float32(7.0)
    return (sgn * (np.power(1.0 + MU4, mag) - 1.0) / MU4).astype(np.float32)


def pack4(codes: np.ndarray) -> np.ndarray:
    """Pack (T, ...) uint8 codes in 0..15 to (T//2, ...) bytes: even time
    sample in the high nibble, odd in the low (T must be even)."""
    codes = np.asarray(codes, np.uint8)
    if codes.shape[0] % 2:
        raise ValueError("pack4 needs an even time axis")
    return (codes[0::2] << 4 | codes[1::2]).astype(np.uint8)


def unpack4(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack4`: (Tp, ...) -> (2*Tp, ...) codes."""
    packed = np.asarray(packed, np.uint8)
    hi = (packed >> 4) & np.uint8(0xF)
    lo = packed & np.uint8(0xF)
    out = np.stack([hi, lo], axis=1)  # (Tp, 2, ...)
    return out.reshape((packed.shape[0] * 2,) + packed.shape[1:])


def mulaw4_decode(code: np.ndarray) -> np.ndarray:
    """Host-side decode of UNPACKED 4-bit codes -> float32."""
    return mulaw4_decode_table()[np.asarray(code, np.int64)]
