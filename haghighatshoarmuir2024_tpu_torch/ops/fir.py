"""Causal FIR filtering on the time axis (counterpart of
``haghighatshoarmuir2024_tpu/ops/fir.py``; reference call sites:
micloc/beamformer.py:132-134, micloc/snn_beamformer.py:158-160).

:func:`fir_filter` is ``scipy.signal.lfilter(b, [1], x)`` by one of three
methods: the zero-padded FFT, the direct convolution, or the
blocked-Toeplitz matmul form :func:`fir_block_matmul` (``_fir_block_matmul``,
``fir.py:110``), the form the STHT of the flagship encode runs.
``moving_average_full`` is the smoothing of ``find_peak_location``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 512  # time block of the Toeplitz slices (the TPU form's block, ``stht.py:62-69``)


def full_fp32() -> None:
    """Keep float32 matrix products float32-exact on the GPU: TF32 keeps
    about three decimal digits, and the lifted IIR went 2.6% off the float64
    reference at a lower precision on the TPU (``CLAUDE.md:61-65``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=16)
def _toeplitz_slices(taps: tuple, block: int, device: torch.device) -> torch.Tensor:
    """(nk, block, block) float32 slices ``A_k[r, c] = b[k·block + r − c]``."""
    b = np.asarray(taps, np.float32)
    K = b.shape[0]
    nk = (K - 1 + block - 1) // block + 1
    r = np.arange(block)
    mats = []
    for k in range(nk):
        idx = k * block + r[:, None] - r[None, :]
        valid = (idx >= 0) & (idx < K)
        mats.append(np.where(valid, b[np.clip(idx, 0, K - 1)], 0.0).astype(np.float32))
    return torch.as_tensor(np.stack(mats), device=device)


def fir_block_matmul(b: np.ndarray, x: torch.Tensor, block: int = BLOCK,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Causal FIR ``y[t] = Σ_k b[k] x[t−k]`` along dim 0 of ``x`` (T, ...),
    zero initial state, as blocked-Toeplitz matmuls: output block n is
    ``Σ_k A_k · x_{n−k}`` (``fir.py:110-153``).  The taps round to float32,
    as JAX's form takes them; the products run in ``dtype`` (float32 on
    every path of the encode).  A short filter takes a smaller ``block``:
    the work per sample is about twice the block."""
    full_fp32()
    T = x.shape[0]
    rest = x.shape[1:]
    block = int(block)
    mats = _toeplitz_slices(tuple(np.asarray(b, np.float64).tolist()), block, x.device).to(dtype)
    nk = mats.shape[0]
    nb = -(-T // block)
    xf = x.reshape(T, -1).to(dtype)
    L = xf.shape[1]
    xp = torch.nn.functional.pad(xf.T, ((nk - 1) * block, nb * block - T))  # (L, Tp)
    Xb = xp.reshape(L, nb + nk - 1, block)
    y = None
    for k in range(nk):
        Xs = Xb[:, nk - 1 - k : nk - 1 - k + nb, :]
        term = torch.matmul(Xs, mats[k].T)  # (L, nb, block)
        y = term if y is None else y + term
    y = y.reshape(L, nb * block)[:, :T].T
    return y.reshape((T,) + rest).to(x.dtype)


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _fir_last(b: torch.Tensor, x: torch.Tensor, method: str) -> torch.Tensor:
    """``fft`` or ``direct`` along the last dim of ``x``: both operands real,
    or (``fft``) both complex."""
    T, K = x.shape[-1], b.shape[0]
    if method == "fft":
        n = _next_pow2(T + K - 1)
        if x.is_complex():
            return torch.fft.ifft(torch.fft.fft(x, n=n) * torch.fft.fft(b.to(x.dtype), n=n))[..., :T]
        return torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(b.to(x.dtype), n=n), n=n)[..., :T]
    if method == "direct":
        full_fp32()
        xb = torch.nn.functional.pad(x.reshape(-1, 1, T), (K - 1, 0))  # causal: K - 1 zeros on the left
        return torch.nn.functional.conv1d(xb, b.flip(0).to(x.dtype).reshape(1, 1, K)).reshape(x.shape)
    raise ValueError(f"unknown FIR method: {method}")


def fir_filter(b, x: torch.Tensor, axis: int = 0, method: str = "auto") -> torch.Tensor:
    """Causal FIR along ``axis`` of real or complex ``x`` with zero initial
    state, ``scipy.signal.lfilter(b, [1], x, axis=axis)`` (JAX ``fir_filter``,
    ``fir.py:31-107``), in ``x``'s dtype on its device.

    ``method``: ``"fft"`` (zero-padded FFT: ``rfft``/``irfft``, the complex
    FFT when both operands are complex), ``"direct"`` (``conv1d`` with causal
    left padding and flipped taps, TF32 off), ``"blockmm"``
    (:func:`fir_block_matmul` at JAX's block of 128; real operands only) or
    ``"auto"``, which picks as JAX does: ``"fft"`` for a CPU tensor, and on
    the card ``"direct"`` up to 64 taps, else ``"fft"``.  A complex ``x``
    with real taps is filtered one part at a time, the real and then the
    imaginary; a real ``x`` keeps its dtype, so complex taps give the real
    part (JAX casts the result to ``x``'s dtype)."""
    b = torch.as_tensor(b, device=x.device)
    if method == "auto":
        method = "fft" if x.device.type == "cpu" else ("direct" if b.shape[0] <= 64 else "fft")
    if method == "blockmm":
        if x.is_complex() or b.is_complex():
            raise ValueError("blockmm FIR supports real signals/taps only")
        return fir_block_matmul(b.cpu().numpy(), x.movedim(axis, 0), block=128, dtype=x.dtype).movedim(0, axis)
    if b.is_complex() and not x.is_complex():
        return fir_filter(b.real, x, axis, method)
    if x.is_complex() and not b.is_complex():
        return torch.complex(fir_filter(b, x.real, axis, method), fir_filter(b, x.imag, axis, method))
    if b.is_complex() and method == "direct":
        return fir_filter(b.real, x, axis, method) + 1j * fir_filter(b.imag, x, axis, method)
    return _fir_last(b, x.movedim(axis, -1), method).movedim(-1, axis)


def moving_average_full(x: torch.Tensor, win_size: int) -> torch.Tensor:
    """``np.convolve(ones(win), x, mode='full')`` along the last dim,
    batched over the leading ones (JAX ``moving_average_full``,
    ``fir.py:156``; reference micloc/utils.py:110-112): (..., T) →
    (..., T + win − 1), as differences of a running sum over the
    zero-padded signal, the sum taken in float64."""
    T = x.shape[-1]
    xp = torch.nn.functional.pad(x.to(torch.float64), (win_size - 1, win_size - 1))
    w = torch.cumsum(xp, dim=-1)
    zero = torch.zeros(w.shape[:-1] + (1,), dtype=w.dtype, device=w.device)
    out = w[..., win_size - 1:] - torch.cat([zero, w[..., : T + win_size - 2]], dim=-1)
    return out.to(x.dtype)
