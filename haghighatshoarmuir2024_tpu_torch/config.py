"""Global constants and the classical families' configurations
(counterpart of ``haghighatshoarmuir2024_tpu/config.py``).

The reference hard-codes these per module (micloc/beamformer.py:23
``Fs = 48_000``, micloc/array_geometry.py:14 ``SOUND_SPEED_IN_OPEN_AIR``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Sampling rate of the 7-mic dev board (reference: micloc/beamformer.py:23).
FS = 48_000

# Speed of sound (reference: micloc/array_geometry.py:14).
SOUND_SPEED_IN_OPEN_AIR = 340.0


@dataclasses.dataclass(frozen=True)
class BeamformerConfig:
    """Configuration of the Hilbert beamformer (micloc/beamformer.py:26-71);
    ``design_chunk`` DoAs of the grid are designed at a time."""

    kernel_duration: float = 10e-3
    freq_range: Tuple[float, float] = (1600.0, 1900.0)
    fs: float = FS
    bandpass_order: int = 2
    design_chunk: int = 64

    @property
    def kernel_length(self) -> int:
        return int(self.fs * self.kernel_duration)


@dataclasses.dataclass(frozen=True)
class SNNBeamformerConfig:
    """Configuration of the float SNN Hilbert beamformer
    (micloc/snn_beamformer.py:24-80; JAX ``config.py:39-59``), the fields
    :meth:`SNNBeamformer.from_config` reads."""

    kernel_duration: float = 10e-3
    freq_range: Tuple[float, float] = (1600.0, 1900.0)
    tau_syn: float = 1.0 / (2.0 * 3.141592653589793 * 1750.0)
    tau_mem: float = 1.0 / (2.0 * 3.141592653589793 * 1750.0)
    bipolar_spikes: bool = False
    fs: float = FS
    bandpass_order: int = 2
    design_chunk: int = 32

    @property
    def kernel_length(self) -> int:
        return int(self.fs * self.kernel_duration)

    @property
    def robust_width(self) -> int:
        """RZCC robust width: half the zero-crossing distance at the band's
        top (micloc/snn_beamformer.py:74-76)."""
        return int(self.fs / self.freq_range[1]) // 2


@dataclasses.dataclass(frozen=True)
class MUSICConfig:
    """Configuration of the narrowband (Bartlett-style) beamformer
    (micloc/music_beamformer.py:22-62)."""

    freq_range: Tuple[float, float] = (1200.0, 2000.0)
    frame_duration: float = 0.25
    fs: float = FS
    bandpass_order: int = 1
