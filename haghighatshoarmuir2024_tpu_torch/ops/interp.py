"""Fractional-delay interpolation — the plane-wave simulation model
(counterpart of ``haghighatshoarmuir2024_tpu/ops/interp.py:18-118``;
micloc/xylo_snn_localization.py:44-71).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def interp_uniform(tq: torch.Tensor, f: torch.Tensor, t0: float, dt: float) -> torch.Tensor:
    """Linear interpolation of ``f`` (1-D, uniform grid ``t0 + k·dt``) at query
    times ``tq`` of any shape; clamps to the end values outside the grid like
    ``np.interp``."""
    T = f.shape[0]
    idx = ((tq - t0) / dt).clamp(0.0, T - 1.0)
    i0 = torch.floor(idx).to(torch.int64)
    if T > 1:
        i0 = torch.clamp(i0, max=T - 2)
    w = (idx - i0).to(f.dtype)
    f0 = f[i0]
    f1 = f[torch.clamp(i0 + 1, max=T - 1)]
    return f0 + (f1 - f0) * w


def resample_to_fs(time_temp, sig_temp, fs: float):
    """Host-side resampling of a template onto the array clock,
    ``np.arange(t.min(), t.max(), 1/fs); np.interp`` (JAX ``interp.py:65-74``;
    micloc/beamformer.py:100-103).  Returns (time, sig) as float64 arrays."""
    time_temp = np.asarray(time_temp, dtype=np.float64)
    sig_temp = np.asarray(sig_temp, dtype=np.float64)
    time_interp = np.arange(time_temp.min(), time_temp.max(), step=1.0 / fs)
    return time_interp, np.interp(time_interp, time_temp, sig_temp)


def delayed_copies(sig: torch.Tensor, t0: float, delays: torch.Tensor, fs: float) -> torch.Tensor:
    """Per-DoA delayed copies of a template: ``out[g, t, m] = sig(t - d[g, m])``
    with ``d = delays - min_m delays`` per DoA and query times clamped at
    ``t0`` (the design's interpolation, JAX ``snn_beamformer.py:46-51``;
    micloc/snn_beamformer.py:139-154).  ``sig`` (T,) is sampled at ``fs``
    from ``t0``; ``delays`` (G, M); the result is (G, T, M) in ``sig``'s
    dtype on its device."""
    T = sig.shape[0]
    t = t0 + torch.arange(T, dtype=sig.dtype, device=sig.device) / fs
    d = delays.to(sig.dtype)
    d = d - d.min(dim=-1, keepdim=True).values
    tq = torch.clamp(t[None, :, None] - d[:, None, :], min=t0)
    return interp_uniform(tq, sig, t0, 1.0 / fs)


def signal_from_template(geometry, time_temp: torch.Tensor, sig_temp: torch.Tensor, doa,
                         fs: Optional[float] = None) -> torch.Tensor:
    """(T, M) array signal from a source at scalar DoA ``doa``: the template
    evaluated at ``t + delay`` with non-normalized delays
    (micloc/xylo_snn_localization.py:44-71).  Computed in ``time_temp``'s
    dtype on its device."""
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    doa = torch.as_tensor(doa, dtype=time_temp.dtype, device=time_temp.device)
    delays = geometry.delays(doa)  # (M,)
    tq = time_temp[:, None] + delays[None, :]
    return interp_uniform(tq, sig_temp, float(time_temp[0]), 1.0 / fs)
