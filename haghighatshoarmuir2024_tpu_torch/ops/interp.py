"""Fractional-delay interpolation — the plane-wave simulation model
(counterpart of ``haghighatshoarmuir2024_tpu/ops/interp.py:18-118``;
micloc/xylo_snn_localization.py:44-71).
"""
from __future__ import annotations

from typing import Optional

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
