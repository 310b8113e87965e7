"""Spike encoders (counterpart of ``haghighatshoarmuir2024_tpu/ops/spikes.py``;
reference: micloc/spike_encoder.py).

Every encoder maps a ``T x C`` signal to a ``T x C`` spike raster along
time (dim 0; :func:`rzcc_encode` and the RZCC encoder take any leading
batch dims, time second to last), vectorized over channels.  The RZCC
encoder is the one of the SNN beamformer's design and of every SNN
pipeline; the integrate-and-fire and peak encoders are the reference's
alternatives.
"""
from __future__ import annotations

import torch

from .peaks import find_peaks_mask


class SpikeEncoder:
    """The encoders' base; calling an encoder runs :meth:`evolve`
    (micloc/spike_encoder.py:15-26)."""

    def evolve(self, sig_in):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.evolve(*args, **kwargs)


def _iaf(x: torch.Tensor, target_spike_rate: float, fs: float) -> torch.Tensor:
    """Integrate-and-fire on ``|x|`` along dim 0: the threshold is
    ``mean(|x|) · fs / target_rate`` over the whole signal, and the raster is
    ``diff(floor(cumsum(|x|) / threshold))`` (T − 1 rows; a count may
    exceed 1)."""
    mag = torch.abs(x)
    threshold = torch.mean(mag) * fs / target_spike_rate
    return torch.diff(torch.floor(torch.cumsum(mag, dim=0) / threshold), dim=0)


class IAFSpikeEncoder(SpikeEncoder):
    """Integrate-and-fire on ``|signal|`` (micloc/spike_encoder.py:29-60)."""

    def __init__(self, target_spike_rate: float, fs: float):
        self.target_spike_rate = target_spike_rate
        self.fs = fs

    def evolve(self, sig_in) -> torch.Tensor:
        return _iaf(torch.as_tensor(sig_in), self.target_spike_rate, self.fs)


class IAFZeroCrossingSpikeEncoder(SpikeEncoder):
    """Integrate-and-fire on ``|cumsum(signal)|`` (micloc/spike_encoder.py:63-97)."""

    def __init__(self, target_spike_rate: float, fs: float):
        self.target_spike_rate = target_spike_rate
        self.fs = fs

    def evolve(self, sig_in) -> torch.Tensor:
        return _iaf(torch.cumsum(torch.as_tensor(sig_in), dim=0), self.target_spike_rate, self.fs)


def rzcc_encode(sig_in: torch.Tensor, robust_width: int, bipolar: bool = False) -> torch.Tensor:
    """Robust zero-crossing spike encoding of a (..., T, C) signal.

    Peaks of ``cumsum(sig)`` along time (robust zero-crossings of ``sig``)
    become +1 spikes; in bipolar mode, peaks of ``-cumsum(sig)`` become -1
    spikes, and -1 overwrites +1 on collision as the reference's sequential
    assignment does.  The raster has ``sig_in``'s dtype.
    """
    cs = torch.cumsum(sig_in.transpose(-1, -2), dim=-1)  # (..., C, T)
    if bipolar:
        C = cs.shape[-2]
        masks = find_peaks_mask(torch.cat([cs, -cs], dim=-2), robust_width)
        peaks, valleys = masks[..., :C, :], masks[..., C:, :]
        spikes = torch.where(valleys, torch.full_like(cs, -1.0), peaks.to(sig_in.dtype))
    else:
        spikes = find_peaks_mask(cs, robust_width).to(sig_in.dtype)
    return spikes.transpose(-1, -2)


class ZeroCrossingSpikeEncoder(SpikeEncoder):
    """The RZCC encoder of all SNN pipelines (micloc/spike_encoder.py:100-137)."""

    def __init__(self, fs: float, robust_width: int = 1, bipolar: bool = False):
        self.fs = fs
        self.robust_width = robust_width
        self.bipolar = bipolar

    def evolve(self, sig_in: torch.Tensor) -> torch.Tensor:
        return rzcc_encode(sig_in, self.robust_width, self.bipolar)


class PeakSpikeEncoder(SpikeEncoder):
    """``find_peaks`` on the raw signal, each channel along time
    (micloc/spike_encoder.py:140-167): a 0/1 raster in the signal's dtype."""

    def __init__(self, fs: float):
        self.fs = fs

    def evolve(self, sig_in, robust_width: int = 1) -> torch.Tensor:
        x = torch.as_tensor(sig_in)
        return find_peaks_mask(x.transpose(-1, -2), robust_width).transpose(-1, -2).to(x.dtype)
