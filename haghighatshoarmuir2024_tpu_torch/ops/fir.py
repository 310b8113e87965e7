"""Causal FIR filtering on the time axis (counterpart of
``haghighatshoarmuir2024_tpu/ops/fir.py``; reference call sites:
micloc/beamformer.py:132-134, micloc/snn_beamformer.py:158-160).

Only the blocked-Toeplitz matmul form (``_fir_block_matmul``, ``fir.py:110``)
is ported: it is the form the STHT of the flagship encode runs.
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


def fir_block_matmul(b: np.ndarray, x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Causal FIR ``y[t] = Σ_k b[k] x[t−k]`` along dim 0 of ``x`` (T, ...),
    zero initial state, as blocked-Toeplitz float32 matmuls: output block n is
    ``Σ_k A_k · x_{n−k}`` (``fir.py:110-153``).  A short filter takes a
    smaller ``block``: the work per sample is about twice the block."""
    full_fp32()
    T = x.shape[0]
    rest = x.shape[1:]
    block = int(block)
    mats = _toeplitz_slices(tuple(np.asarray(b, np.float64).tolist()), block, x.device)
    nk = mats.shape[0]
    nb = -(-T // block)
    xf = x.reshape(T, -1).to(torch.float32)
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
