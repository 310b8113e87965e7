"""The RZCC spike encoder of the SNN beamformer's design (counterpart of
``haghighatshoarmuir2024_tpu/ops/spikes.py:59-92``; reference:
micloc/spike_encoder.py:100-137).

Maps a ``T x C`` signal to a ``T x C`` spike raster, vectorized over
channels and any leading batch dims.
"""
from __future__ import annotations

import torch

from .peaks import find_peaks_mask


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


class ZeroCrossingSpikeEncoder:
    """The RZCC encoder of all SNN pipelines (micloc/spike_encoder.py:100-137);
    calling it runs :meth:`evolve`."""

    def __init__(self, fs: float, robust_width: int = 1, bipolar: bool = False):
        self.fs = fs
        self.robust_width = robust_width
        self.bipolar = bipolar

    def evolve(self, sig_in: torch.Tensor) -> torch.Tensor:
        return rzcc_encode(sig_in, self.robust_width, self.bipolar)

    __call__ = evolve
