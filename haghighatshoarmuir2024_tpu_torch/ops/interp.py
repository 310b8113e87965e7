"""Fractional-delay interpolation — the plane-wave simulation model
(counterpart of ``haghighatshoarmuir2024_tpu/ops/interp.py``;
micloc/xylo_snn_localization.py:44-71), and the reverberant room beyond
it: a source over several plane-wave paths
(:func:`signal_from_template_multipath`) whose path table the image-source
model of a rectangular room gives (:func:`room_image_paths`).
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
                         fs: Optional[float] = None, delay_sign: int = 1) -> torch.Tensor:
    """(T, M) array signal from a source at DoA ``doa``, a scalar or a
    per-sample (T,) trajectory: the template evaluated at ``t + delay``
    with non-normalized delays (micloc/xylo_snn_localization.py:44-71; JAX
    ``interp.py:76-117``).

    ``delay_sign=-1`` evaluates it at ``t - delay`` instead, the
    reference's MUSIC synthesis convention (micloc/music_beamformer.py:
    307-312): MUSIC's and SRP-PHAT's physical steering matches it, and
    plus-convention audio mirrors their estimates by 180°.  Computed in
    ``time_temp``'s dtype on its device."""
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    doa = torch.as_tensor(doa, dtype=time_temp.dtype, device=time_temp.device)
    delays = delay_sign * geometry.delays(doa)  # (M,) or (T, M)
    tq = time_temp[:, None] + (delays if delays.dim() == 2 else delays[None, :])
    return interp_uniform(tq, sig_temp, float(time_temp[0]), 1.0 / fs)


def received_signal(geometry, time_temp: torch.Tensor, sig_temp: torch.Tensor, doa, snr_db=None,
                    generator: Optional[torch.Generator] = None, fs: Optional[float] = None) -> torch.Tensor:
    """Template → (T, M) array signal with optional white noise at ``snr_db``
    per microphone, the simulation harness of every ``apply_to_template``
    (micloc/beamformer.py:233-253; JAX ``interp.py:120-153``): delays
    normalized together (their global minimum subtracted), the template
    evaluated at ``t - delay`` with query times clamped at ``t0``, then AWGN
    of sigma ``rms(sig) / sqrt(snr)``.

    ``doa`` is a scalar or a per-sample (T,) trajectory.  The noise comes
    from ``generator`` (a ``torch.Generator`` on ``time_temp``'s device),
    which must be given with ``snr_db``."""
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    doa = torch.as_tensor(doa, dtype=time_temp.dtype, device=time_temp.device)
    delays = geometry.delays(doa.reshape(-1))  # (Td, M)
    delays = delays - delays.min()
    if delays.shape[0] != time_temp.shape[0]:
        delays = delays[:1]
    t0 = float(time_temp[0])
    tq = torch.clamp(time_temp[:, None] - delays, min=t0)
    sig = interp_uniform(tq, sig_temp, t0, 1.0 / fs)
    if snr_db is None:
        return sig
    if generator is None:
        raise ValueError("pass a torch.Generator `generator` when snr_db is given")
    sigma = torch.sqrt(torch.mean(sig**2)) / np.sqrt(10.0 ** (float(snr_db) / 10.0))
    noise = torch.randn(sig.shape, generator=generator, dtype=sig.dtype, device=sig.device)
    return sig + sigma * noise


def signal_from_template_multipath(geometry, time_temp: torch.Tensor, sig_temp: torch.Tensor, doas, extra_delays,
                                   gains, fs: Optional[float] = None) -> torch.Tensor:
    """The array signal of a source over several plane-wave paths (JAX
    ``interp.py:156-192``; beyond the reference, whose model is one plane
    wave a source): path p arrives from ``doas[p]``, ``extra_delays[p]``
    seconds after the direct path, scaled by ``gains[p]``, and the received
    signal is ``sum_p gains[p] · sig(t + mic_delay(doas[p]) − extra_delays[p])``
    with non-normalized delays, as :func:`signal_from_template`.

    ``doas``, ``extra_delays`` and ``gains`` are (P,) for one source, giving
    (T, M), or (B, P) for a batch of trials, giving (B, T, M); computed in
    ``time_temp``'s dtype on its device.  :func:`room_image_paths` makes the
    path table of a rectangular room."""
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    opts = dict(dtype=time_temp.dtype, device=time_temp.device)
    doas = torch.as_tensor(doas, **opts)
    extra = torch.as_tensor(extra_delays, **opts)
    gains = torch.as_tensor(gains, **opts)
    single = doas.dim() <= 1
    doas, extra, gains = (x.reshape(1, -1) if single else x for x in (doas, extra, gains))
    delays = geometry.delays(doas)  # (B, P, M)
    tq = time_temp[None, None, :, None] + delays[:, :, None, :] - extra[:, :, None, None]  # (B, P, T, M)
    copies = interp_uniform(tq, sig_temp, float(time_temp[0]), 1.0 / fs)
    out = torch.einsum("bp,bptm->btm", gains.to(copies.dtype), copies)
    return out[0] if single else out


def room_image_paths(source_xy, array_xy, room_wh, reflection: float = 0.7, order: int = 1, speed: float = 340.0):
    """The path table of a 2-D rectangular room by the image-source method,
    to order 1 or 2 (host numpy; the port's copy of JAX ``interp.py:195-251``):
    the source's images across each wall and wall pair arrive as plane waves
    from the image's direction with gain ``reflection**bounces · d_direct /
    d_image`` and extra delay ``(d_image − d_direct) / speed``.  Walls at
    x = 0, W and y = 0, H for ``room_wh = (W, H)``.

    Returns ``(doas, extra_delays, gains)``, (P,) float64 each, the direct
    path first (P = 5 at order 1, 13 at order 2)."""
    sx, sy = float(source_xy[0]), float(source_xy[1])
    ax, ay = float(array_xy[0]), float(array_xy[1])
    W, H = float(room_wh[0]), float(room_wh[1])
    if not (0 < sx < W and 0 < sy < H and 0 < ax < W and 0 < ay < H):
        raise ValueError("source and array must lie inside the room")
    # per axis: the source, its images across the walls at 0 and W (one
    # bounce), and at order 2 their images again (two bounces); a 2-D image
    # pairs an x image with a y image, its bounces summed
    xs = [(sx, 0), (-sx, 1), (2 * W - sx, 1)]
    ys = [(sy, 0), (-sy, 1), (2 * H - sy, 1)]
    if order >= 2:
        xs += [(2 * W + sx, 2), (-2 * W + sx, 2)]
        ys += [(2 * H + sy, 2), (-2 * H + sy, 2)]
    paths = []
    for ix, bx in xs:
        for iy, by in ys:
            b = bx + by
            if (b == 0 and not (ix == sx and iy == sy)) or b > order:
                continue
            paths.append((np.arctan2(iy - ay, ix - ax), np.hypot(ix - ax, iy - ay), b))
    doas, dists, bounces = (np.array([p[k] for p in paths]) for k in range(3))
    gains = (reflection ** bounces) * (dists[0] / dists)
    return doas, (dists - dists[0]) / speed, gains
