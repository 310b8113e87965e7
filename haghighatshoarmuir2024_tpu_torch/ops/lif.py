"""Float-level LIF synapse+membrane filtering of the SNN beamformer's design
(counterpart of ``haghighatshoarmuir2024_tpu/ops/lif.py``; reference:
micloc/snn_beamformer.py:117-137, 173-174).

The neuron is a linear filter with the normalized, truncated
synapse+membrane impulse response, built on the host from the static taus and
applied as a short causal FIR.  The quantized integer LIF is
``models/xylo/sim.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .fir import fir_block_matmul


def lif_impulse_response(
    tau_syn: float, tau_mem: float, fs: float, max_len: int, mass: float = 0.999
) -> np.ndarray:
    """Normalized LIF impulse response truncated at ``mass`` cumulative mass
    (JAX ``lif.py:19-43``).

    Equal taus: ``(t/tau) * exp(-t/tau)`` (micloc/snn_beamformer.py:121-124).
    Unequal taus: the difference of exponentials
    ``(exp(-t/tau_syn) - exp(-t/tau_mem)) / (1/tau_mem - 1/tau_syn)``.

    NOTE: the reference's unequal-tau branch (micloc/snn_beamformer.py:126-128)
    carries a sign bug (``exp(+t/tau_mem)``) guarded by an assert; every caller
    uses equal taus so the branch is dead.  The mathematically correct kernel
    is used, as in the JAX package.

    Returns a float64 host array of length <= max_len.
    """
    t = np.arange(max_len, dtype=np.float64) / fs
    if tau_mem == tau_syn:
        h = (t / tau_syn) * np.exp(-t / tau_syn)
    else:
        h = (np.exp(-t / tau_syn) - np.exp(-t / tau_mem)) / (1.0 / tau_mem - 1.0 / tau_syn)
        h = np.abs(h)
    h = h / np.sum(h)
    effective_length = int(np.sum(np.cumsum(h) < mass))
    return h[:effective_length]


def lif_filter(spikes: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Membrane potential = causal FIR of the spike trains (T, ...) with the
    LIF kernel ``h`` along dim 0 (micloc/snn_beamformer.py:173-174), as the
    blocked-Toeplitz float32 matmul of the STHT, in 64-sample blocks (the
    kernel is about 40 taps at 1750 Hz)."""
    return fir_block_matmul(h, spikes, block=64)
